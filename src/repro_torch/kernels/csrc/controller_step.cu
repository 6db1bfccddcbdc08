// The fused controller step: one launch per executed cycle does, for every
// lane, what repro_torch.core.controller.step_and_horizon_plain does:
// the timing-readiness table, the request candidates and filtering
// predicates, the refresh engine, the FR-FCFS / FCFS pick, the command
// issue with all its state effects (twice, column pass then row pass, on
// a dual command bus), the packed events, and the event horizon at
// clk + 1 on the new state.  Bit for bit, in int32 arithmetic taken modulo
// 2^32 where PyTorch's int32 tensors wrap.
//
// A lane is one channel of one design point.  The state arrays hold
// P * C lanes, point-major, and the grid has one block per lane, so one
// launch steps a whole batch of design points (the reference's vmap over
// load points and channels).  Each block reads its point's clock from the
// device array clk[P] and its flag from active[P]; an inactive point's
// lanes write idle events and the horizon kHorizonMax and leave their
// state alone.  A single run is a batch of one point.
//
// Replaces the TPU kernel src/repro/kernels/timing_check.py::maxplus_matmul
// (_maxplus_kernel), the fp32 (max,+) product of gathered timestamps and the
// constraint matrix: stage A below computes that product as the dense
// (n_cmds, n_banks) int32 table with the key loop of readiness_keys.cuh,
// and the stages after it consume the table in shared memory instead of
// sending it back to the host's eager code.
//
// The modern-controller features ride the same stages: a link latency L
// (a spec group behind a CXL-style link) hides a request until
// clk >= arrive + L, delays its read completion by L and bounds the
// horizon by arrive + L; BlockHammer keeps a count-min sketch of row opens
// (two rows of kSketch counters per lane) that blacklists hot rows,
// counts every open and halves on nREFI multiples, once per pass; PRAC
// counts opens per bank, and a bank at the threshold makes its refresh
// unit due and urgent at once and blocks its requests until the REFab
// that resets the unit's counters.  The plan's header words LinkLatency,
// BhThreshold and PracThreshold switch them on (0: off).  User predicates
// are Python code: the caller evaluates them on the pass's starting state
// and hands the kernel their verdict, one byte per queue slot, which stage B
// ANDs in; a dual command bus then takes one launch per pass, since the row
// pass's context follows the column pass's issue.  Each of the four is a
// template flag (Feature), and the launch picks the instance from the plan's
// header and the mask's presence, so a run without a feature pays nothing
// for its gates.
//
// What bounds it on an H100: latency, not bytes or operations.  Per lane
// it moves a few KB (the controller state in and out, about 2.4 KB for
// DDR5; with BlockHammer the 8 KB sketch in and out as well) and does a
// few thousand integer operations, so its bound is well under a
// microsecond, while the dependent chain of stages below costs a few
// microseconds of shared-memory round trips and barriers.  The design
// therefore keeps everything in one block per lane and in shared memory,
// with one barrier between stages and shared-memory atomics for the
// reductions (deferred count, any-hit, the scheduler's argmin, the
// horizon's min), so no stage waits on device memory after the stage-in.
// Each stage walks one index space over all its items (cells, slots,
// units, banks, levels, ring rows), so at DDR5's shapes every item has a
// thread of its own, and loops with the block's stride beyond that:
// nothing depends on the block size.
//
// Stages (a __syncthreads() between each):
//   0  stage in: the plan's header from the kernel's parameters, then its
//      tables, the lane's DeviceState, queue, hit streaks, PRAC counters,
//      (BlockHammer on) sketch and (user predicates) mask, all loads in
//      flight together (one device-memory latency); a launch of the row
//      pass alone takes the column pass's events from the events row;
//   per pass (one, or column then row on a dual command bus, or the one
//   pass the launch asks for):
//   A  the readiness table (one (cmd, bank) cell per thread); per queue
//      slot its flat bank, prerequisite command, command row and row hit;
//      per refresh unit its PRAC alert, due / urgent flags and refresh
//      command;
//   B  per slot timing readiness, link visibility, the pass's command-kind
//      mask and the predicates (refresh urgency; for split activation
//      ACT-2 follows ACT-1 and an urgent ACT-2 goes first; BlockHammer;
//      PRAC; the user mask), the deferred count, the any-hit flag and the scheduler key
//      ((row miss), arrive, slot): its minimum is argmin's first index;
//      one more thread picks the refresh unit (argmax of overdue time,
//      first on ties) and decides the refresh;
//   C  the issue of the refresh command or the pick: last-issue stamps at
//      every level up to the command's scope, the ring shift-insert of the
//      entries the command and its node own, the row-state effects in the
//      order OPEN, CLOSE, CLOSE_ALL, ACT1, the data clock, last_ref, the
//      PRAC reset or count, the hit streak, the served slot's valid bit and
//      the pass's events; the sketch's count of the open and its decay;
//   H  (fast-forward only) the horizon at clk + 1: per valid slot the
//      readiness of its prerequisite command (not before arrive + L), per
//      refresh unit its due time (now, on a PRAC alert) against the
//      readiness of its refresh command, the data clock's expiry and the
//      next sketch decay; min over all, at least clk + 1;
//   9  stage out: the state back in place, the events packed as
//      repro_torch.core.controller._pack_events does (a pass that did not
//      run is idle there).
//
// The layout of the constant plan (Header), of the events row (Event) and
// the feature flags (Feature) are mirrored in repro_torch/kernels/controller_step.py; a CPU test reads
// both enums from this file and compares them.
//
// C interface, bound with ctypes from repro_torch/kernels/controller_step.py.

#include <cuda_runtime.h>

#include "readiness_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQueue = 256;      // also the scheduler key's 8-bit slot field
constexpr int kMaxNodes = 128;
constexpr int kMaxCmds = 16;
constexpr int kMaxBanks = 128;
constexpr int kMaxUnits = 8;
constexpr int kMaxRingRows = 8;
constexpr int kMaxRingDepth = 8;
constexpr int kMaxSubLevels = 5;
constexpr int kMaxConsts = 1024;
constexpr int kSketch = 1024;       // BlockHammer sketch width (a power of 2)

constexpr int kRowClosed = -1;
constexpr int kRowActivating = -2;
constexpr int kHorizonMax = 1 << 30;

constexpr int kFxOpen = 1;
constexpr int kFxClose = 2;
constexpr int kFxCloseAll = 4;
constexpr int kFxAct1 = 8;
constexpr int kFxClockOn = 16;
constexpr int kFxFinalRd = 32;
constexpr int kFxFinalWr = 64;

// The packed constant plan: these header words, then the tables at the
// offsets the header gives.
enum Header : int {
  kQ, kL1, kF, kB, kU, kN, kR, kW, kK, kNRing, kBpr,
  kSplit, kDcs, kDual, kRefresh, kFcfs,
  kIdPre, kIdOpener, kIdAct2, kIdRd, kIdWr, kIdSyncRd, kIdSyncWr, kIdRefab,
  kIdPreab,
  kNREFI, kNAAD, kClockIdle, kReadLatency, kUrgentMargin,
  kLinkLatency, kBhThreshold, kPracThreshold,
  kOffKeys, kOffA, kOffScope, kOffFx, kOffPass, kOffBankStride, kOffNodeMul,
  kOffNodeOff, kOffRingCmd, kOffRingLevel, kOffRingNode,
  kNConsts,
  kHeaderWords
};

// One lane's row of the int32 events buffer; the bool fields are bytes of
// the same row.
enum Event : int {
  kEvCmd = 0, kEvBank = 2, kEvRow = 4, kEvArrive = 6, kEvProbeLatency = 8,
  kEvProbeCompletion = 9, kEvDeferred = 10, kEvHorizon = 11,
  kEvHitReadyByte = 48, kEvServedReadByte = 50, kEvServedWriteByte = 51,
  kEvServedProbeByte = 52,
  kEvWords = 16
};

// The template flags of a kernel instance: the features whose gates it
// compiles in (kFeatures instances in all).
enum Feature : int {
  kFeatLink = 1, kFeatBh = 2, kFeatPrac = 4, kFeatUser = 8, kFeatures = 16
};

// One pass's events, before packing.
struct PassEvents {
  int cmd, bank, row, arrive, hit_ready, served_read, served_write,
      served_probe, probe_latency, probe_completion, deferred;
};


struct StepPtrs {
  const int* consts;
  int* last_issue;
  int* win_ring;
  int* row_state;
  int* act1_row;
  int* act1_clk;
  int* clock_until;
  int* last_ref;
  int* hit_streak;
  int* prac_count;
  int* bh_sketch;               // (2, kSketch) per lane
  unsigned char* valid;
  const unsigned char* is_write;
  const unsigned char* is_probe;
  const int* sub;
  const int* row;
  const int* arrive;
  int* out;
  const int* clk;               // (P,) per-point clocks
  const unsigned char* active;  // (P,) per-point flags
  const unsigned char* user_mask;  // (Q,) per lane: the user predicates
};

constexpr int kNumPtrs = sizeof(StepPtrs) / sizeof(void*);

// The kernel's parameters: the pointers and the plan's header words, so
// the block knows every size before its first device-memory load.
struct StepArgs {
  StepPtrs p;
  int head[kHeaderWords];
};

// Stage-in loads in flight per thread before the first store.
constexpr int kLoadsPerThread = 8;

struct Smem {
  int consts[kMaxConsts];
  int li[kMaxNodes * kMaxCmds];
  int ring[kMaxRingRows * kMaxRingDepth];
  int table[kMaxCmds * kMaxBanks];
  int rs[kMaxBanks], a1r[kMaxBanks], a1c[kMaxBanks], streak[kMaxBanks],
      prac[kMaxBanks];
  int cu[kMaxUnits], lr[kMaxUnits];
  int due[kMaxUnits], urgent[kMaxUnits], ref_cmd[kMaxUnits],
      alert[kMaxUnits];
  int sub[kMaxQueue * kMaxSubLevels];
  int row[kMaxQueue], arrive[kMaxQueue];
  int bank[kMaxQueue], cand_cmd[kMaxQueue], cand_row[kMaxQueue];
  unsigned char valid[kMaxQueue], is_write[kMaxQueue], is_probe[kMaxQueue],
      open_hit[kMaxQueue], umask[kMaxQueue];
  // per-pass reductions and decisions
  unsigned long long best[2];
  int any_urgent2[2], deferred[2], hit_any[2];
  unsigned pending_units[2];
  int ref_do[2], ref_ru[2], ref_cmd_sel[2];
  PassEvents ev[2];
  int horizon;
};

// BlockHammer's sketch (8 KB per lane) lives in dynamic shared memory, sized
// only for the instances that have it, so the others keep the smaller
// footprint.  With it the block needs about 43 KB in all: under the 48 KB a
// launch takes without a cudaFuncSetAttribute call.
constexpr int kSketchBytes = 2 * kSketch * static_cast<int>(sizeof(int));
static_assert(sizeof(Smem) + kSketchBytes <= 48 * 1024,
              "shared memory exceeds 48 KB");

using readiness::wrap_add;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Next command of queue slot q at cycle clk (device.prereq): its flat bank,
// command, the row the command targets, and whether the slot's row is open.
__device__ __forceinline__ void prereq(const Smem& s, const int* c, int q,
                                       int clk, int& bank, int& cmd,
                                       int& cmd_row, bool& open_hit) {
  const int L1 = c[kL1];
  const int* sub = s.sub + q * L1;
  const int* stride = c + c[kOffBankStride];
  int b = 0;
  for (int i = 0; i < L1; ++i) b += sub[i] * stride[i];
  const int rs = s.rs[b];
  const int row = s.row[q];
  const bool hit = rs == row;
  const bool wr = s.is_write[q];
  int col = wr ? c[kIdWr] : c[kIdRd];
  if (c[kDcs] && !(clk < s.cu[sub[0]]))
    col = wr ? c[kIdSyncWr] : c[kIdSyncRd];
  int m = hit ? col : c[kIdPre];
  int m_row = row;
  if (c[kSplit]) {
    if (rs == kRowActivating) m = c[kIdAct2];
    if (rs == kRowClosed) m = c[kIdOpener];
    if (m == c[kIdAct2]) m_row = s.a1r[b];
  } else if (rs == kRowClosed) {
    m = c[kIdOpener];
  }
  bank = b;
  cmd = m;
  cmd_row = m_row;
  open_hit = hit;
}

__device__ __forceinline__ int ready_at(const Smem& s, const int* c, int f,
                                        int b) {
  return readiness::cell(s.li, s.ring, c + c[kOffKeys], c + c[kOffA], c[kK],
                         c[kF], c[kW], f, b);
}

// Any bank of refresh unit u not closed (an activating bank counts as open);
// branch-free, so the loads of the unit's banks overlap.
__device__ __forceinline__ bool unit_open(const Smem& s, int u, int bpr) {
  int open = 0;
#pragma unroll 8
  for (int b = u * bpr; b < (u + 1) * bpr; ++b) open |= s.rs[b] != kRowClosed;
  return open;
}

// PRAC: a bank of refresh unit u has reached the alert threshold.
template <int Feat>
__device__ __forceinline__ bool unit_alert(const Smem& s, const int* c,
                                           int u) {
  if (!(Feat & kFeatPrac)) return false;
  const int thr = c[kPracThreshold], bpr = c[kBpr];
  int alert = 0;
  for (int b = u * bpr; b < (u + 1) * bpr; ++b) alert |= s.prac[b] >= thr;
  return alert;
}

// The link latency of an instance (0 without the flag).
template <int Feat>
__device__ __forceinline__ int link_of(const int* c) {
  return (Feat & kFeatLink) ? c[kLinkLatency] : 0;
}

// BlockHammer's two sketch hashes of (bank, row), in uint32 arithmetic.
__device__ __forceinline__ void bh_hashes(int bank, int row, int& h0,
                                          int& h1) {
  const unsigned k = static_cast<unsigned>(bank) * 1000003u +
                     static_cast<unsigned>(row);
  h0 = static_cast<int>(((k * 2654435761u) >> 5) & (kSketch - 1));
  h1 = static_cast<int>((k * 40503u + 2057u) & (kSketch - 1));
}

// The refresh engine's choice (controller._try_issue_refresh): the most
// overdue due unit (first on ties), its command, and whether it fires.
__device__ void refresh_decision(Smem& s, const int* c, int pass, int clk) {
  const int U = c[kU], bpr = c[kBpr];
  int ru = 0, best = s.due[0] ? wrap_sub(clk, s.lr[0]) : -1;
  bool any_due = s.due[0];
  for (int u = 1; u < U; ++u) {
    const int score = s.due[u] ? wrap_sub(clk, s.lr[u]) : -1;
    if (score > best) {
      best = score;
      ru = u;
    }
    any_due = any_due || s.due[u];
  }
  const int cmd = s.ref_cmd[ru];
  const bool ready = clk >= s.table[cmd * c[kB] + ru * bpr];
  const bool pending = (s.pending_units[pass] >> ru) & 1u;
  const bool may_go = s.urgent[ru] || !pending;
  s.ref_do[pass] = any_due && ready && may_go &&
                   ((c[c[kOffPass] + cmd] >> pass) & 1);
  s.ref_ru[pass] = ru;
  s.ref_cmd_sel[pass] = cmd;
}

// The pass's events, and the served slot's valid bit cleared.
template <int Feat>
__device__ void pass_events(Smem& s, const int* c, int pass, int clk,
                            int slot, bool pick, bool ref, bool fin_rd,
                            bool fin_wr) {
  if (fin_rd || fin_wr) s.valid[slot] = 0;
  const bool probe = fin_rd && s.is_probe[slot];
  const int completion = wrap_add(wrap_add(clk, c[kReadLatency]),
                                  link_of<Feat>(c));
  const int arrive = s.arrive[slot];
  PassEvents& ev = s.ev[pass];
  ev.cmd = pick ? s.cand_cmd[slot] : (ref ? s.ref_cmd_sel[pass] : -1);
  ev.bank = pick ? s.bank[slot] : (ref ? s.ref_ru[pass] * c[kBpr] : -1);
  ev.row = pick ? s.cand_row[slot] : -1;
  ev.arrive = pick ? arrive : -1;
  ev.hit_ready = s.hit_any[pass] && !ref;
  ev.served_read = fin_rd;
  ev.served_write = fin_wr;
  ev.served_probe = probe;
  ev.probe_latency = probe ? wrap_sub(completion, arrive) : 0;
  ev.probe_completion = probe ? completion : 0;
  ev.deferred = s.deferred[pass];
}

// One selection pass (controller._select_and_issue) on the shared state.
template <int Feat>
__device__ void select_and_issue(Smem& s, int* sketch, const int* c,
                                 int pass, int clk) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Q = c[kQ], L1 = c[kL1], F = c[kF], B = c[kB], U = c[kU];
  const int bpr = c[kBpr];
  const int* pass_bits = c + c[kOffPass];
  const int* fx_of = c + c[kOffFx];

  // Each stage walks one index space over all its kinds of items, so each
  // item has a thread of its own (with 256 threads, at DDR5's shapes).

  // ---- A: readiness table, candidates, refresh plan
  const int cells = F * B;
  for (int i = tid; i < cells + Q + U; i += nt) {
    if (i < cells) {
      const int f = i / B;
      s.table[i] = ready_at(s, c, f, i - f * B);
      continue;
    }
    if (i >= cells + Q) {
      // a PRAC alert makes the unit due, and urgent at once
      const int u = i - cells - Q;
      const int since = wrap_sub(clk, s.lr[u]);
      const bool due_time = since >= c[kNREFI];
      const bool alert = unit_alert<Feat>(s, c, u);
      const bool due = due_time || alert;
      const bool urgent =
          (since >= wrap_add(c[kNREFI], c[kUrgentMargin]) ||
           (alert && !due_time)) &&
          due;
      if (Feat & kFeatPrac) s.alert[u] = alert;
      s.due[u] = c[kRefresh] && due;
      s.urgent[u] = c[kRefresh] && urgent;
      s.ref_cmd[u] = unit_open(s, u, bpr) ? c[kIdPreab] : c[kIdRefab];
      continue;
    }
    const int q = i - cells;
    int bank, cmd, cmd_row;
    bool hit;
    prereq(s, c, q, clk, bank, cmd, cmd_row, hit);
    s.bank[q] = bank;
    s.cand_cmd[q] = cmd;
    s.cand_row[q] = cmd_row;
    s.open_hit[q] = hit;
    // an urgent pending ACT-2 anywhere in the queue (valid or not)
    if (c[kSplit] && s.rs[bank] == kRowActivating &&
        clk + 2ll >= wrap_add(s.a1c[bank], c[kNAAD]))
      atomicOr(&s.any_urgent2[pass], 1);
    if (s.valid[q]) atomicOr(&s.pending_units[pass], 1u << s.sub[q * L1]);
  }
  __syncthreads();

  // ---- B: masks, predicates, scheduler key; the refresh decision
  for (int q = tid; q <= Q; q += nt) {
    if (q == Q) {
      refresh_decision(s, c, pass, clk);
      continue;
    }
    const int cmd = s.cand_cmd[q], bank = s.bank[q], ru = s.sub[q * L1];
    bool m = s.valid[q] && clk >= s.table[cmd * B + bank] &&
             ((pass_bits[cmd] >> pass) & 1) &&
             (!(Feat & kFeatLink) ||
              clk >= wrap_add(s.arrive[q], c[kLinkLatency]));
    const bool pre = m;
    if (Feat & kFeatUser) m = m && s.umask[q];
    m = m && !s.urgent[ru];
    if (c[kSplit]) {
      const bool is_act2 = cmd == c[kIdAct2];
      const bool activating = s.rs[bank] == kRowActivating;
      const bool urgent2 =
          activating && clk + 2ll >= wrap_add(s.a1c[bank], c[kNAAD]);
      m = m && (!is_act2 || activating);
      m = m && ((is_act2 && urgent2) || !s.any_urgent2[pass]);
    }
    if ((Feat & kFeatBh) && cmd == c[kIdOpener]) {
      int h0, h1;
      bh_hashes(bank, s.cand_row[q], h0, h1);
      m = m && min(sketch[h0], sketch[kSketch + h1]) < c[kBhThreshold];
    }
    if (Feat & kFeatPrac) m = m && !s.alert[ru];
    if (pre && !m) atomicAdd(&s.deferred[pass], 1);
    if (m && s.open_hit[q]) atomicOr(&s.hit_any[pass], 1);
    if (m) {
      const unsigned long long miss = c[kFcfs] ? 0 : !s.open_hit[q];
      const unsigned order = static_cast<unsigned>(s.arrive[q]) ^ 0x80000000u;
      atomicMin(&s.best[pass], (miss << 40) |
                                   (static_cast<unsigned long long>(order)
                                    << 8) |
                                   static_cast<unsigned long long>(q));
    }
  }
  __syncthreads();

  // ---- C: issue the refresh command or the pick (at most one fires)
  const unsigned long long best = s.best[pass];
  const bool ok = best != ~0ull;
  const int slot = ok ? static_cast<int>(best & 0xFFull) : 0;
  const bool ref = s.ref_do[pass];
  const bool pick = ok && !ref;
  const int ref_ru = s.ref_ru[pass], ref_cmd = s.ref_cmd_sel[pass];
  const int qcmd = s.cand_cmd[slot], qrow = s.cand_row[slot];
  const int qbank = s.bank[slot];
  const int qfx = fx_of[qcmd];
  const bool fin_rd = pick && (qfx & kFxFinalRd);
  const bool fin_wr = pick && (qfx & kFxFinalWr);
  const int L = L1 + 1;
  const int cmd = ref ? ref_cmd : qcmd;
  const int row = ref ? 0 : qrow;
  // the issued command's address: the pick's, or (unit, 0, ...) for refresh
  auto isub = [&](int i) {
    return ref ? (i == 0 ? ref_ru : 0) : s.sub[slot * L1 + i];
  };
  const int* stride = c + c[kOffBankStride];
  const int* mul = c + c[kOffNodeMul];
  const int* off = c + c[kOffNodeOff];
  auto node_at = [&](int l) {
    int node = off[l];
    for (int i = 0; i < L1; ++i) node += isub(i) * mul[i * L + l];
    return node;
  };
  int bank = 0;
  for (int i = 0; i < L1; ++i) bank += isub(i) * stride[i];
  const int ru = isub(0);
  const int fx = fx_of[cmd];
  const int scope = c[c[kOffScope] + cmd];
  const int until = wrap_add(clk, c[kClockIdle]);
  // BlockHammer: the pick's row open counts in both sketch rows, and the
  // sketch halves on nREFI multiples (in every pass, as the reference)
  const bool opened = pick && qcmd == c[kIdOpener];
  const bool decay = (Feat & kFeatBh) && clk % c[kNREFI] == 0;
  int sk0 = -1, sk1 = -1;
  if ((Feat & kFeatBh) && opened) bh_hashes(qbank, qrow, sk0, sk1);
  // items: banks, units, the levels to stamp, ring rows (when a command
  // issues), the pass's events, then the sketch's counters (when an open
  // counts or the sketch decays)
  const int n_issue = (pick || ref) ? B + U + L + c[kNRing] : 0;
  const int n_sketch = (Feat & kFeatBh) && (opened || decay) ? 2 * kSketch : 0;
  for (int i = tid; i <= n_issue + n_sketch; i += nt) {
    if (i > n_issue) {
      const int j = i - n_issue - 1;
      int v = sketch[j];
      if (opened && (j == sk0 || j == kSketch + sk1)) v += 1;
      if (decay) v >>= 1;
      sketch[j] = v;
    } else if (i == n_issue) {
      pass_events<Feat>(s, c, pass, clk, slot, pick, ref, fin_rd, fin_wr);
    } else if (i < B) {
      const int b = i;
      const bool hit = b == bank;
      int rs = s.rs[b];
      if ((fx & kFxOpen) && hit) rs = row;
      if ((fx & kFxClose) && hit) rs = kRowClosed;
      if ((fx & kFxCloseAll) && b / bpr == ru) rs = kRowClosed;
      if ((fx & kFxAct1) && hit) {
        rs = kRowActivating;
        s.a1r[b] = row;
        s.a1c[b] = clk;
      }
      s.rs[b] = rs;
      // PRAC: a refresh resets its unit's activation counters, an open
      // counts
      if (ref && ref_cmd == c[kIdRefab] && b / bpr == ref_ru) s.prac[b] = 0;
      if ((Feat & kFeatPrac) && opened && b == qbank) s.prac[b] += 1;
      // row-hit streak of the pick's bank
      if (pick && b == qbank) {
        int st = s.streak[b];
        if (fin_rd || fin_wr) st += 1;
        if (qcmd == c[kIdOpener]) st = 0;
        s.streak[b] = st;
      }
    } else if (i < B + U) {
      const int u = i - B;
      if (u != ru) continue;
      int cu = s.cu[u];
      if (fx & kFxClockOn) cu = until;
      if (c[kDcs] && (fx & (kFxFinalRd | kFxFinalWr))) cu = max(cu, until);
      s.cu[u] = cu;
      if (cmd == c[kIdRefab]) s.lr[u] = clk;
    } else if (i < B + U + L) {
      // last-issue stamps at every level up to the command's scope
      const int l = i - B - U;
      if (l <= scope) s.li[node_at(l) * F + cmd] = clk;
    } else {
      // shift-insert the ring entries owned by (cmd, its node at their
      // level)
      const int r = i - B - U - L;
      if (c[c[kOffRingCmd] + r] != cmd ||
          node_at(c[c[kOffRingLevel] + r]) != c[c[kOffRingNode] + r])
        continue;
      const int W = c[kW];
      int* e = s.ring + r * W;
      for (int w = W - 1; w > 0; --w) e[w] = e[w - 1];
      e[0] = clk;
    }
  }
  __syncthreads();
}

// controller.channel_horizon_plain at clk1 on the shared state.
template <int Feat>
__device__ void horizon(Smem& s, const int* c, int clk1) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Q = c[kQ], U = c[kU];
  // the last item (BlockHammer only): the next sketch decay
  const int n = Q + U + ((Feat & kFeatBh) ? 1 : 0);
  for (int i = tid; i < n; i += nt) {
    if (i < Q) {
      if (!s.valid[i]) continue;
      int bank, cmd, cmd_row;
      bool hit;
      prereq(s, c, i, clk1, bank, cmd, cmd_row, hit);
      int t = ready_at(s, c, cmd, bank);
      if (Feat & kFeatLink) t = max(t, wrap_add(s.arrive[i], c[kLinkLatency]));
      atomicMin(&s.horizon, t);
      continue;
    }
    if (i == Q + U) {
      // the next sketch decay must be executed, not skipped
      const int r = c[kNREFI];
      atomicMin(&s.horizon, (clk1 + r - 1) / r * r);
      continue;
    }
    const int u = i - Q;
    if (c[kRefresh]) {
      const int cmd = unit_open(s, u, c[kBpr]) ? c[kIdPreab] : c[kIdRefab];
      const int due_t =
          unit_alert<Feat>(s, c, u) ? clk1 : wrap_add(s.lr[u], c[kNREFI]);
      atomicMin(&s.horizon, max(due_t, ready_at(s, c, cmd, u * c[kBpr])));
    }
    if (c[kDcs]) atomicMin(&s.horizon, s.cu[u] <= clk1 ? kHorizonMax : s.cu[u]);
  }
  __syncthreads();
}

// The events row of a lane that executes no cycle (a finished point):
// nothing issued, served or deferred, and no horizon.
__device__ void idle_events(int* o) {
  for (int i = threadIdx.x; i < kEvWords; i += blockDim.x)
    o[i] = i < kEvProbeLatency ? -1 : (i == kEvHorizon ? kHorizonMax : 0);
}

template <typename T>
__device__ __forceinline__ void copy(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Element i of the stage-in's index space (the plan's tables, the device
// state, the queue; int32 words, then the queue's bool bytes): its shared
// destination and device source.  Returns false past the end.
template <int Feat>
__device__ __forceinline__ bool locate(Smem& s, int* sketch,
                                       const StepPtrs& p, const int* h,
                                       int lane, int i,
                                       void*& dst, const void*& src,
                                       bool& byte) {
  const int Q = h[kQ], L1 = h[kL1], B = h[kB], U = h[kU];
  const int NF = h[kN] * h[kF], RW = h[kR] * h[kW];
#define SEGMENT(DST, SRC, N)   \
  if (i < (N)) {               \
    dst = (DST) + i;           \
    src = (SRC) + i;           \
    return true;               \
  }                            \
  i -= (N);
  byte = false;
  SEGMENT(s.consts + kHeaderWords, p.consts + kHeaderWords,
          h[kNConsts] - kHeaderWords)
  SEGMENT(s.li, p.last_issue + lane * NF, NF)
  SEGMENT(s.ring, p.win_ring + lane * RW, RW)
  SEGMENT(s.rs, p.row_state + lane * B, B)
  SEGMENT(s.a1r, p.act1_row + lane * B, B)
  SEGMENT(s.a1c, p.act1_clk + lane * B, B)
  SEGMENT(s.streak, p.hit_streak + lane * B, B)
  SEGMENT(s.prac, p.prac_count + lane * B, B)
  SEGMENT(sketch, p.bh_sketch + lane * 2 * kSketch,
          (Feat & kFeatBh) ? 2 * kSketch : 0)
  SEGMENT(s.cu, p.clock_until + lane * U, U)
  SEGMENT(s.lr, p.last_ref + lane * U, U)
  SEGMENT(s.sub, p.sub + lane * Q * L1, Q * L1)
  SEGMENT(s.row, p.row + lane * Q, Q)
  SEGMENT(s.arrive, p.arrive + lane * Q, Q)
  byte = true;
  SEGMENT(s.valid, p.valid + lane * Q, Q)
  SEGMENT(s.is_write, p.is_write + lane * Q, Q)
  SEGMENT(s.is_probe, p.is_probe + lane * Q, Q)
  SEGMENT(s.umask, p.user_mask + lane * Q, (Feat & kFeatUser) ? Q : 0)
#undef SEGMENT
  return false;
}

// Stage in: kLoadsPerThread loads per thread are issued into registers
// before the first of them is stored, so the whole lane arrives in one
// device-memory latency instead of one per array.
template <int Feat>
__device__ void stage_in(Smem& s, int* sketch, const StepPtrs& p,
                         const int* h, int lane) {
  const int Q = h[kQ];
  const int total = h[kNConsts] - kHeaderWords + h[kN] * h[kF] +
                    h[kR] * h[kW] + 5 * h[kB] +
                    ((Feat & kFeatBh) ? 2 * kSketch : 0) + 2 * h[kU] +
                    Q * (h[kL1] + 2) + 3 * Q + ((Feat & kFeatUser) ? Q : 0);
  for (int base = threadIdx.x; base < total;
       base += kLoadsPerThread * blockDim.x) {
    void* dst[kLoadsPerThread];
    int v[kLoadsPerThread];
    bool byte[kLoadsPerThread];
#pragma unroll
    for (int k = 0; k < kLoadsPerThread; ++k) {
      const void* src;
      if (!locate<Feat>(s, sketch, p, h, lane, base + k * blockDim.x,
                        dst[k], src, byte[k])) {
        dst[k] = nullptr;
        continue;
      }
      v[k] = byte[k] ? *static_cast<const unsigned char*>(src)
                     : *static_cast<const int*>(src);
    }
#pragma unroll
    for (int k = 0; k < kLoadsPerThread; ++k) {
      if (!dst[k]) continue;
      if (byte[k])
        *static_cast<unsigned char*>(dst[k]) = static_cast<unsigned char>(v[k]);
      else
        *static_cast<int*>(dst[k]) = v[k];
    }
  }
}

// The events of a pass that issues nothing (the row slot of a single bus).
__device__ __forceinline__ PassEvents idle_pass() {
  return {-1, -1, -1, -1, 0, 0, 0, 0, 0, 0, 0};
}

// The events row of the column pass, as a launch of it alone packed it.
__device__ PassEvents unpack_pass0(const int* o) {
  const unsigned char* ob = reinterpret_cast<const unsigned char*>(o);
  return {o[kEvCmd],          o[kEvBank],
          o[kEvRow],          o[kEvArrive],
          ob[kEvHitReadyByte], ob[kEvServedReadByte],
          ob[kEvServedWriteByte], ob[kEvServedProbeByte],
          o[kEvProbeLatency], o[kEvProbeCompletion],
          o[kEvDeferred]};
}

// only_pass: -1 runs every pass of the standard, 0 or 1 that pass alone.
template <int Feat>
__global__ void __launch_bounds__(kThreads)
    controller_step_kernel(StepArgs a, int channels, int want_horizon,
                           int only_pass) {
  __shared__ Smem s;
  extern __shared__ int sketch[];     // (2, kSketch): BlockHammer only
  const StepPtrs& p = a.p;
  const int lane = blockIdx.x, tid = threadIdx.x;
  // both loads in flight together: one device-memory latency
  const int point = lane / channels;
  const int clk = p.clk[point];
  int* o = p.out + lane * kEvWords;
  if (!p.active[point]) {
    idle_events(o);
    return;
  }

  // ---- 0: stage in
  for (int i = tid; i < kHeaderWords; i += blockDim.x) s.consts[i] = a.head[i];
  stage_in<Feat>(s, sketch, p, a.head, lane);
  for (int i = tid; i < 2; i += blockDim.x) {
    s.best[i] = ~0ull;
    s.any_urgent2[i] = s.deferred[i] = s.hit_any[i] = 0;
    s.pending_units[i] = 0u;
  }
  if (tid == 0) {
    s.horizon = kHorizonMax;
    s.ev[0] = only_pass == 1 ? unpack_pass0(o) : idle_pass();
    s.ev[1] = idle_pass();
  }
  __syncthreads();
  const int* c = s.consts;
  const int Q = c[kQ], B = c[kB], U = c[kU];
  const int NF = c[kN] * c[kF], RW = c[kR] * c[kW];

  const int first = only_pass < 0 ? 0 : only_pass;
  const int last = only_pass < 0 ? (c[kDual] ? 2 : 1) : only_pass + 1;
  for (int pass = first; pass < last; ++pass)
    select_and_issue<Feat>(s, sketch, c, pass, clk);
  if (want_horizon) horizon<Feat>(s, c, clk + 1);

  // ---- 9: stage out
  copy(p.last_issue + lane * NF, s.li, NF);
  copy(p.win_ring + lane * RW, s.ring, RW);
  copy(p.row_state + lane * B, s.rs, B);
  copy(p.act1_row + lane * B, s.a1r, B);
  copy(p.act1_clk + lane * B, s.a1c, B);
  copy(p.hit_streak + lane * B, s.streak, B);
  copy(p.prac_count + lane * B, s.prac, B);
  if (Feat & kFeatBh) copy(p.bh_sketch + lane * 2 * kSketch, sketch,
                        2 * kSketch);
  copy(p.clock_until + lane * U, s.cu, U);
  copy(p.last_ref + lane * U, s.lr, U);
  copy(p.valid + lane * Q, s.valid, Q);
  if (tid == 0) {
    unsigned char* ob = reinterpret_cast<unsigned char*>(o);
    const PassEvents& e = s.ev[0];
    const PassEvents& f = s.ev[1];
    o[kEvCmd] = e.cmd;
    o[kEvCmd + 1] = f.cmd;
    o[kEvBank] = e.bank;
    o[kEvBank + 1] = f.bank;
    o[kEvRow] = e.row;
    o[kEvRow + 1] = f.row;
    o[kEvArrive] = e.arrive;
    o[kEvArrive + 1] = f.arrive;
    o[kEvProbeLatency] = wrap_add(e.probe_latency, f.probe_latency);
    o[kEvProbeCompletion] = wrap_add(e.probe_completion, f.probe_completion);
    o[kEvDeferred] = wrap_add(e.deferred, f.deferred);
    if (want_horizon) o[kEvHorizon] = max(s.horizon, clk + 1);
    ob[kEvHitReadyByte] = e.hit_ready;
    ob[kEvHitReadyByte + 1] = f.hit_ready;
    ob[kEvServedReadByte] = e.served_read || f.served_read;
    ob[kEvServedWriteByte] = e.served_write || f.served_write;
    ob[kEvServedProbeByte] = e.served_probe || f.served_probe;
  }
}

template <int Feat>
void launch(const StepArgs& a, int lanes, int channels, int want_horizon,
            int only_pass, cudaStream_t stream) {
  controller_step_kernel<Feat>
      <<<lanes, kThreads, (Feat & kFeatBh) ? kSketchBytes : 0, stream>>>(
          a, channels, want_horizon, only_pass);
}

using Launch = void (*)(const StepArgs&, int, int, int, int, cudaStream_t);

constexpr Launch kLaunch[kFeatures] = {
    launch<0>, launch<1>, launch<2>,  launch<3>,  launch<4>,  launch<5>,
    launch<6>, launch<7>, launch<8>,  launch<9>,  launch<10>, launch<11>,
    launch<12>, launch<13>, launch<14>, launch<15>};

}  // namespace

// ptrs: kNumPtrs device pointers in the order of StepPtrs (user_mask null
// unless `features` has kFeatUser); head: the plan's kHeaderWords header
// words, in host memory; `features`: the instance, whose link, BlockHammer
// and PRAC flags must match the header's words; only_pass: -1 (every pass),
// or 0 or 1 (that pass alone: a dual bus with user predicates).  Launches
// one block per lane (lanes = points * channels) on `stream`; returns the
// launch's cudaError_t (cudaErrorInvalidValue for arguments that disagree).
extern "C" int controller_step_launch(void* const* ptrs, const int* head,
                                      int lanes, int channels,
                                      int want_horizon, int only_pass,
                                      int features, void* stream) {
  StepArgs a;
  void** dst = reinterpret_cast<void**>(&a.p);
  for (int i = 0; i < kNumPtrs; ++i) dst[i] = ptrs[i];
  for (int i = 0; i < kHeaderWords; ++i) a.head[i] = head[i];
  const bool flags_ok =
      features >= 0 && features < kFeatures &&
      !(features & kFeatLink) == !head[kLinkLatency] &&
      !(features & kFeatBh) == !head[kBhThreshold] &&
      !(features & kFeatPrac) == !head[kPracThreshold] &&
      !(features & kFeatUser) == !a.p.user_mask;
  const bool pass_ok = only_pass == -1 || only_pass == 0 ||
                       (only_pass == 1 && head[kDual]);
  if (!flags_ok || !pass_ok || lanes < 1 || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  kLaunch[features](a, lanes, channels, want_horizon, only_pass,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int controller_step_num_ptrs() { return kNumPtrs; }

extern "C" const char* controller_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
