"""The plain versions of kernels K3 (row-band A-apply) and K4 (staged
A-apply) against the JAX package's Pallas kernels in interpret mode, the
port's `make_fused_apply_kernel` for every halo against
`make_fused_apply_pallas`, and the wrappers' argument checks. The kernels
themselves run only on a card: tests/test_torch_cuda_kernels.py.
Tolerances are relative to max|JAX|: 2e-6 in f32, 1e-12 in f64 (operation
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpbp_tpu.models import fused as jax_fused
from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu.ops.pallas_stencil import build_fused_tile_call
from mpbp_tpu_torch.models import fused
from mpbp_tpu_torch.models.multiphase import operator_from_numpy
from mpbp_tpu_torch.ops import cuda_stencil

torch.set_num_threads(1)

DTYPES = [pytest.param(jnp.float32, torch.float32, 2e-6, id="f32"),
          pytest.param(jnp.float64, torch.float64, 1e-12, id="f64")]


def port_of(jop, dtype):
    return operator_from_numpy(np.asarray(jop.phase_n.cell),
                               np.asarray(jop.phase_n.xface_pt),
                               np.asarray(jop.phase_n.yface_pt), jop.params,
                               device="cpu", dtype=dtype)


def close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("jdt,dtype,tol", DTYPES)
def test_band_reference_matches_pallas_k3_interpret(jdt, dtype, tol):
    """A band of n_loc=16 rows of an n=32 grid with H=8 halo rows on each
    side, all random: the halo rows are not the band's periodic wrap, so a
    kernel that wrapped rows would fail here."""
    n_loc, n, H = 16, 32, 8
    jop = jax_make_operator(n, eta_n=100.0, dtype=jdt)
    npdt = np.dtype(jdt)
    rng = np.random.default_rng(7)
    tn_ext = rng.uniform(0.1, 0.9, (n_loc + 2 * H, n)).astype(npdt)
    wnx, wny = (rng.uniform(0.1, 0.9, (n_loc, n)).astype(npdt)
                for _ in range(2))
    x_ext = rng.normal(size=(5, n_loc + 2 * H, n)).astype(npdt)
    dx, dy = jop.grid.dx, jop.grid.dy
    call = build_fused_tile_call(n_loc, n, jdt, jop.params, dx, dy,
                                 block_rows=16, interpret=True)
    want = call(*(jnp.asarray(a) for a in (tn_ext, wnx, wny, x_ext)))
    got = cuda_stencil.a_apply_band(
        *(torch.as_tensor(a) for a in (tn_ext, wnx, wny, x_ext)),
        jop.params, dx, dy, H)
    close(got, want, tol)


@pytest.mark.parametrize("halo", ["inkernel", "extend", "pipelined"])
@pytest.mark.parametrize("jdt,dtype,tol", DTYPES)
def test_fused_apply_kernel_matches_pallas_interpret(halo, jdt, dtype, tol):
    n = 32
    jop = jax_make_operator(n, eta_n=100.0, dtype=jdt)
    v = np.random.default_rng(3).normal(size=(5, n, n)).astype(
        np.dtype(jdt))
    want = jax_fused.make_fused_apply_pallas(
        jop, interpret=True, block_rows=16, halo=halo)(jnp.asarray(v))
    got = fused.make_fused_apply_kernel(port_of(jop, dtype), halo)(
        torch.as_tensor(v))
    close(got, want, tol)


@pytest.mark.parametrize("h", [1, 8])
def test_band_of_the_periodic_grid_equals_the_full_apply(h):
    """Rows r0.. of the periodic grid, with their true neighbour rows as
    the halo, give exactly those rows of the full apply."""
    n, n_loc, r0 = 24, 7, 9
    op = port_of(jax_make_operator(n, eta_n=100.0), torch.float64)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(5, n, n)))
    tn, wx, wy = op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt
    full = cuda_stencil.a_apply_reference(tn, wx, wy, x, op.params,
                                          op.grid.dx, op.grid.dy)
    band = cuda_stencil.a_apply_band(
        tn[r0 - h:r0 + n_loc + h].contiguous(),
        wx[r0:r0 + n_loc].contiguous(), wy[r0:r0 + n_loc].contiguous(),
        x[:, r0 - h:r0 + n_loc + h].contiguous(), op.params, op.grid.dx,
        op.grid.dy, h)
    torch.testing.assert_close(band, full[:, r0:r0 + n_loc], rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    n = 16
    op = port_of(jax_make_operator(n), torch.float64)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(5, n, n)))
    before = dict(cuda_stencil.LAUNCHES)
    want = fused.make_fused_apply(op)(x)
    for halo in ("extend", "pipelined"):
        torch.testing.assert_close(fused.make_fused_apply_kernel(op, halo)(x),
                                   want, rtol=0, atol=0)
    assert cuda_stencil.LAUNCHES == before


def test_extend_rows_appends_the_periodic_wrap():
    x = torch.arange(2 * 5 * 4, dtype=torch.float64).reshape(2, 5, 4)
    ext = fused._extend_rows(x, 2)
    assert ext.shape == (2, 9, 4)
    torch.testing.assert_close(ext[:, 2:7], x)
    torch.testing.assert_close(ext[:, :2], x[:, 3:])
    torch.testing.assert_close(ext[:, 7:], x[:, :2])


def test_wrong_shapes_dtypes_and_tiles_raise():
    n, h = 8, 2
    op = port_of(jax_make_operator(n), torch.float64)
    tn, wx, wy = op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt
    p, dx = op.params, op.grid.dx
    x = torch.zeros(5, n, n, dtype=torch.float64)
    t_ext, x_ext = fused._extend_rows(tn, h), fused._extend_rows(x, h)
    band = cuda_stencil.a_apply_band
    with pytest.raises(ValueError):                 # h < 1
        band(t_ext, wx, wy, x_ext, p, dx, dx, 0)
    with pytest.raises(ValueError):                 # 4 state planes
        band(t_ext, wx, wy, x_ext[:4].contiguous(), p, dx, dx, h)
    with pytest.raises(ValueError):                 # theta without halo
        band(tn, wx, wy, x_ext, p, dx, dx, h)
    with pytest.raises(ValueError):                 # face plane with halo
        band(t_ext, fused._extend_rows(wx, h), wy, x_ext, p, dx, dx, h)
    with pytest.raises(ValueError):                 # no interior rows
        band(t_ext[:2 * h].contiguous(), wx[:0], wy[:0],
             x_ext[:, :2 * h].contiguous(), p, dx, dx, h)
    with pytest.raises(TypeError):                  # mixed dtypes
        band(t_ext.float(), wx, wy, x_ext, p, dx, dx, h)
    with pytest.raises(TypeError):                  # no kernel for float16
        band(t_ext.half(), wx.half(), wy.half(), x_ext.half(), p, dx, dx, h)
    with pytest.raises(ValueError):                 # non-contiguous state
        band(t_ext, wx, wy, x_ext.transpose(1, 2).contiguous()
             .transpose(1, 2), p, dx, dx, h)

    staged = cuda_stencil.a_apply_staged
    with pytest.raises(ValueError):                 # not square
        staged(tn, wx, wy, x[:, :4].contiguous(), p, dx, dx)
    with pytest.raises(TypeError):
        staged(tn.float(), wx, wy, x, p, dx, dx)
    for tile in ((8, 48), (0, 64), (8,), "8x64", (64, 256)):
        with pytest.raises(ValueError):             # (64, 256) f64: 1.6 MB
            staged(tn, wx, wy, x, p, dx, dx, tile=tile)

    for halo, tile in (("inkernel", (8, 64)), ("extend", (8, 64)),
                       ("pipelined", (8, 40)), ("rolled", None)):
        with pytest.raises(ValueError):
            fused.make_fused_apply_kernel(op, halo, tile=tile)


@pytest.mark.parametrize("dtype,lead", [(torch.float32, 4),
                                        (torch.float64, 2)])
def test_k4_footprint_rows_put_the_tile_on_16_byte_boundaries(dtype, lead):
    """K4's shared-memory layout: a footprint row is the tile's columns
    between two 16-byte leads (the left halo column ends the first, the
    right halo column starts the second), so the tile's first column and
    every row start 16-byte aligned; two slots of 6 planes of rows+2
    footprint rows; the default tile fits in either dtype."""
    size = dtype.itemsize
    assert lead * size == 16
    for tc in (32, 64, 96, 128, 256):
        ld = cuda_stencil.staged_row_stride(tc, dtype)
        assert ld == tc + 2 * lead and ld * size % 16 == 0
        assert cuda_stencil.staged_smem_bytes((5, tc), dtype) == \
            2 * 6 * 7 * ld * size
    tile = cuda_stencil.STAGED_TILE
    assert cuda_stencil.check_tile(None, dtype) == tile
    assert cuda_stencil.staged_smem_bytes(tile, dtype) <= \
        cuda_stencil._SMEM_OPTIN_MAX


@pytest.mark.parametrize("tile,dtype,fits", [
    ((16, 128), torch.float32, True), ((32, 128), torch.float32, True),
    ((64, 128), torch.float32, False), ((16, 128), torch.float64, True),
    ((32, 64), torch.float64, True), ((32, 128), torch.float64, False)])
def test_check_tile_holds_two_slots_within_shared_memory(tile, dtype, fits):
    """The largest tiles: 16x128 f64 takes 228,096 of the 232,448 bytes a
    block may opt in to; 32x128 f64 would take 430,848."""
    if fits:
        assert cuda_stencil.check_tile(tile, dtype) == tile
    else:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_stencil.check_tile(tile, dtype)
