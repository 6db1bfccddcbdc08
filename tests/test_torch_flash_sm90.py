"""The Python side of the port's tensor-core flash-attention kernel
(``csrc/flash_attention_sm90.cu``), on the CPU: which kernel a case goes
to, the TMA geometry each tensor is launched with, and the alignment checks
that make the wrapper raise where TMA cannot take a tensor.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,D,want", [
    (BF16, 64, "sm90"), (BF16, 128, "sm90"),
    (BF16, 16, "cuda_core"), (BF16, 32, "cuda_core"),
    (F32, 16, "cuda_core"), (F32, 32, "cuda_core"),
    (F32, 64, "cuda_core"), (F32, 128, "cuda_core"),
])
def test_route_by_dtype_and_head_dim(dtype, D, want):
    assert FA.route(dtype, D) == want


@pytest.mark.parametrize("head_axis", [1, 2])
def test_route_ignores_layout(head_axis):
    """Both layouts of one case go to one kernel, and both plan."""
    shape = (2, 4, 100, 64) if head_axis == 1 else (2, 100, 4, 64)
    q = torch.zeros(shape, dtype=BF16)
    assert FA.route(q.dtype, q.shape[-1]) == "sm90"
    gq, gk, gv, go = FA.sm90_plan(q, q, q, torch.empty_like(q), head_axis)
    assert gq.dims == (64, 100, 4, 2) == gk.dims == gv.dims == go.dims
    assert (gq.box_rows, gk.box_rows, go.box_rows) == (128, 128, 64)


def test_geometry_bhtd_layout():
    q = torch.zeros(2, 8, 300, 64, dtype=BF16)
    g = FA.tma_geometry(q, 1, FA.SM90_BLOCK_Q)
    assert g.dims == (64, 300, 8, 2)
    assert g.strides == (64 * 2, 300 * 64 * 2, 8 * 300 * 64 * 2)
    assert (g.box_cols, g.box_rows, g.n_boxes) == (64, 128, 1)
    assert g.packed() == (64, 300, 8, 2, 128, 38400, 307200, 128)


def test_geometry_bthd_layout():
    """The model's layout: the head stride is smaller than the time
    stride; TMA takes the dims in (D, T, H, B) order all the same."""
    k = torch.zeros(4, 1000, 8, 64, dtype=BF16)
    g = FA.tma_geometry(k, 2, FA.SM90_BLOCK_K)
    assert g.dims == (64, 1000, 8, 4)
    assert g.strides == (8 * 64 * 2, 64 * 2, 1000 * 8 * 64 * 2)


def test_geometry_of_fused_qkv_views():
    """q, k, v as head slices of one (B, T, Hq + 2 Hkv, D) tensor: each
    keeps the parent's strides and starts at its own offset."""
    B, T, Hq, Hkv, D = 2, 50, 8, 2, 64
    qkv = torch.zeros(B, T, Hq + 2 * Hkv, D, dtype=BF16)
    q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
    gq, gk, gv, go = FA.sm90_plan(q, k, v, torch.empty(B, T, Hq, D,
                                                       dtype=BF16), 2)
    assert go.strides == (Hq * D * 2, D * 2, T * Hq * D * 2)
    row = (Hq + 2 * Hkv) * D * 2
    assert gq.dims == (D, T, Hq, B) and gk.dims == (D, T, Hkv, B)
    for g in (gq, gk, gv):
        assert g.strides == (row, D * 2, T * row)
    assert v.data_ptr() - qkv.data_ptr() == (Hq + Hkv) * D * 2


def test_geometry_d128_is_two_boxes():
    q = torch.zeros(1, 200, 4, 128, dtype=BF16)
    g = FA.tma_geometry(q, 2, FA.SM90_BLOCK_Q)
    assert g.dims == (128, 200, 4, 1)
    assert (g.box_cols, g.n_boxes) == (64, 2)
    assert g.box_cols * 2 == 128          # bytes: the 128-byte swizzle limit


def test_geometry_replaces_strides_of_length_one_axes():
    """An axis of length 1 is never stepped: its stride may be anything
    (here 1 element, from slicing one head) and is replaced."""
    q = torch.zeros(1, 40, 3, 64, dtype=BF16)[:, :, 1:2]
    g = FA.tma_geometry(q, 2, FA.SM90_BLOCK_Q)
    assert g.dims == (64, 40, 1, 1)
    assert g.strides == (3 * 64 * 2, 128, 128)


def test_plan_rejects_misaligned_base():
    flat = torch.zeros(1 + 2 * 64 * 4 * 64, dtype=BF16)
    q = flat[1:].view(2, 64, 4, 64)                  # base 2 bytes off
    assert q.data_ptr() % 16 == 2
    ok = torch.zeros(2, 64, 4, 64, dtype=BF16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.sm90_plan(q, ok, ok, ok, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.sm90_plan(ok, ok, q, ok, 2)


@pytest.mark.parametrize("pad", [4, 1])
def test_plan_rejects_misaligned_stride(pad):
    """D padded to 64 + pad elements: the time stride is no multiple of
    16 bytes (base aligned)."""
    q = torch.zeros(2, 32, 1, 64 + pad, dtype=BF16)[..., :64]
    assert q.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="multiple of 16"):
        FA.sm90_plan(q, q, q, torch.empty_like(q), 2)


def test_plan_rejects_head_dim_that_is_not_whole_boxes():
    q = torch.zeros(1, 16, 2, 32, dtype=BF16)
    with pytest.raises(ValueError, match="multiple of 64"):
        FA.sm90_plan(q, q, q, q, 2)


def test_cpu_tensors_take_the_plain_version_on_either_route():
    before = (FA.launch_count, FA.sm90_launch_count)
    for dtype, D in ((BF16, 64), (BF16, 32), (F32, 64)):
        q = torch.randn(1, 20, 2, D).to(dtype)
        out = FA.flash_attention_bthd(q, q, q, causal=True)
        assert out.shape == q.shape and out.dtype == dtype
    assert (FA.launch_count, FA.sm90_launch_count) == before
