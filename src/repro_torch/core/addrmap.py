"""Address mappers: linear physical address <-> DRAM address vector.

The counterpart of ``repro.core.addrmap`` for one spec.  ``AddressMapper``
lowers a mapper *order* string (Ramulator convention: Row / Bank(+group)
/ Rank / Column / Channel fields listed MSB -> LSB) into a mixed-radix
``layout`` — a list of ``(field_name, count)`` pairs, least-significant
first — over the compiled spec's geometry.

``decode_fields``/``encode_fields`` use only ``%``, ``//`` and ``*``, so
they work the same on Python ints, numpy int64 arrays and torch integer
tensors; the frontend decodes its linear request counter through the same
layout (``repro_torch.core.frontend``).  The system-level mapper of
heterogeneous compositions is not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.compile import CompiledSpec, as_system


def _field_bits(n: int) -> int:
    return max(int(np.ceil(np.log2(max(n, 1)))), 0)


def make_layout(cspec: CompiledSpec, order: str) -> list:
    """Lower a mapper order string to ``[(field, count), ...]`` LSB-first.

    Field names are ``"channel"``, the spec's sub-channel levels (rank /
    bankgroup / bank / pseudochannel...), ``"row"`` and ``"col"``.
    """
    sub_levels = cspec.levels[1:]
    bank_like = [lv for lv in sub_levels if lv in ("bankgroup", "bank")]
    rank_like = [lv for lv in sub_levels if lv not in ("bankgroup", "bank")]
    counts = {lv: int(cspec.level_counts[i + 1])
              for i, lv in enumerate(sub_levels)}
    field_defs = {
        "Ch": [("channel", int(cspec.n_channels))],
        "Ra": [(lv, counts[lv]) for lv in rank_like],
        "Ba": [(lv, counts[lv]) for lv in bank_like],
        "Ro": [("row", int(cspec.rows))],
        "Co": [("col", int(cspec.columns))],
    }
    toks = [order[i:i + 2] for i in range(0, len(order), 2)]
    if sorted(toks) != sorted(field_defs):
        raise ValueError(f"bad mapper order {order!r}: need each of "
                         f"{sorted(field_defs)} exactly once")
    lsb_first = []
    for tok in reversed(toks):          # order string is MSB -> LSB
        lsb_first.extend(field_defs[tok])
    return lsb_first


def decode_fields(layout, value):
    """Mixed-radix decode of a line index through ``layout`` (LSB-first)."""
    out = {}
    q = value
    for name, count in layout:
        out[name] = q % count
        q = q // count
    return out


def encode_fields(layout, fields):
    """Inverse of :func:`decode_fields`: fold a field dict back into the
    line index (MSB-first accumulate)."""
    a = None
    for name, count in reversed(layout):    # MSB first
        f = fields[name]
        a = f if a is None else a * count + f
    return 0 if a is None else a


class AddressMapper:
    """Decode/encode linear addresses through a mapper layout.

    ``order`` reads MSB->LSB, e.g. ``"RoBaRaCoCh"`` is
    Row | Bank | Rank | Column | Channel (channel bits least significant).
    """

    def __init__(self, cspec: CompiledSpec, order: str = "RoBaRaCoCh",
                 tx_bytes: int | None = None):
        self.cspec = cspec
        self.order = order
        self.tx_bits = _field_bits(tx_bytes or cspec.access_bytes)
        self.layout = make_layout(cspec, order)   # [(name, count)] LSB-first

    def map(self, addr):
        """addr (bytes) -> dict of address fields (vectorized)."""
        return decode_fields(self.layout, addr >> self.tx_bits)

    def encode(self, fields: dict):
        """Inverse of :meth:`map`: field dict -> linear byte address."""
        return encode_fields(self.layout, fields) << self.tx_bits

    def to_chan_sub_row_col(self, addr):
        """addr -> (channel, sub[levels-1], row, col) numpy arrays."""
        f = self.map(np.asarray(addr, np.int64))
        sub = np.stack([f.get(lv, np.zeros_like(f["row"]))
                        for lv in self.cspec.levels[1:]], axis=-1)
        return f["channel"], sub, f["row"], f["col"]


#: Supported mapper orders (MSB -> LSB).
MAPPERS = ["RoBaRaCoCh", "RoRaBaCoCh", "RoCoBaRaCh"]


def make_system_layout(msys, order: str):
    """Lower a mapper order for a memory system: ``("single", layout)``
    for a 1-group system (any order), else ``("multi", n_channels, bases,
    sublayouts)`` where ``sublayouts[g]`` is group ``g``'s LSB-first
    layout without the channel field and ``bases[g]`` its first system
    channel id.  A channel field above the LSB is refused for several
    groups."""
    if msys.n_groups == 1:
        return ("single", make_layout(msys.groups[0].cspec, order))
    toks = [order[i:i + 2] for i in range(0, len(order), 2)]
    if toks[-1] != "Ch":
        raise ValueError(
            f"mapper order {order!r} puts the channel field above the LSB "
            "— heterogeneous systems need channel-least-significant orders "
            f"(supported: {MAPPERS}) so the post-channel remainder can be "
            "decoded per spec group")
    subs = tuple(tuple((n, c) for (n, c) in make_layout(g.cspec, order)
                       if n != "channel") for g in msys.groups)
    return ("multi", int(msys.n_channels),
            tuple(int(b) for b in msys.chan_base), subs)


class SystemAddressMapper:
    """Decode/encode linear addresses across a memory system of spec
    groups: consecutive transaction-sized lines interleave across all
    system channels, and the rest of the line index decodes through the
    owning group's layout.  ``tx_bytes`` defaults to the largest group
    ``access_bytes``."""

    def __init__(self, msys, order: str = "RoBaRaCoCh",
                 tx_bytes: int | None = None):
        self.msys = as_system(msys)
        self.order = order
        self.tx_bits = _field_bits(
            tx_bytes or max(g.cspec.access_bytes for g in self.msys.groups))
        kind = make_system_layout(self.msys, order)
        if kind[0] == "single":
            self._single = AddressMapper(self.msys.groups[0].cspec, order,
                                         tx_bytes)
        else:
            self._single = None
            _, self.n_channels, self.bases, self.sublayouts = kind

    def to_chan_sub_row_col(self, addr):
        """addr (bytes) -> (chan, sub, row, col) numpy arrays; ``chan`` is
        the system channel id and ``sub`` is padded to the widest group's
        sub-level count (group ``g`` uses its first ``len(levels_g) - 1``
        entries, the rest are zero)."""
        if self._single is not None:
            return self._single.to_chan_sub_row_col(addr)
        a = np.asarray(addr, np.int64) >> self.tx_bits
        chan = a % self.n_channels
        q = a // self.n_channels
        groups = self.msys.groups
        gid = self.msys.chan_group[chan]
        width = max(len(g.cspec.levels) - 1 for g in groups)
        sub = np.zeros(a.shape + (width,), np.int64)
        row = np.zeros_like(a)
        col = np.zeros_like(a)
        for g, (grp, lay) in enumerate(zip(groups, self.sublayouts)):
            m = gid == g
            if not np.any(m):
                continue
            f = decode_fields(lay, q[m])
            for i, lv in enumerate(grp.cspec.levels[1:]):
                sub[m, i] = f.get(lv, 0)
            row[m] = f["row"]
            col[m] = f["col"]
        return chan, sub, row, col

    def encode(self, chan, sub, row, col):
        """Inverse of :meth:`to_chan_sub_row_col` -> linear byte address."""
        if self._single is not None:
            fields = {"channel": np.asarray(chan, np.int64),
                      "row": np.asarray(row, np.int64),
                      "col": np.asarray(col, np.int64)}
            sub = np.asarray(sub, np.int64)
            for i, lv in enumerate(self.msys.groups[0].cspec.levels[1:]):
                fields[lv] = sub[..., i]
            return self._single.encode(fields)
        chan = np.asarray(chan, np.int64)
        sub = np.asarray(sub, np.int64)
        row = np.asarray(row, np.int64)
        col = np.asarray(col, np.int64)
        gid = self.msys.chan_group[chan]
        q = np.zeros_like(chan)
        for g, (grp, lay) in enumerate(zip(self.msys.groups,
                                           self.sublayouts)):
            m = gid == g
            if not np.any(m):
                continue
            fields = {"row": row[m], "col": col[m]}
            for i, lv in enumerate(grp.cspec.levels[1:]):
                fields[lv] = sub[m, i]
            q[m] = encode_fields(lay, fields)
        return (q * self.n_channels + chan) << self.tx_bits
