"""K1 (RMSNorm) launch geometry, on the CPU: what a launch on the card
runs with is a pure function of the shapes, ``block_rows`` and the SM
count (``rmsnorm.geometry``).  The kernel itself runs only on the card
(``chip_smoke.py``); its plain version is held to the oracle here."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms
from repro_torch.tuning.kernel_objective import kernel_space

SMS = 132  # an H100 SXM
ROWS = [1, 7, 8, 100, 131, 1055, 1056, 1057, 4096, 8192, 65536]
WIDTHS = [33, 64, 100, 256, 768, 896, 2560, 4096, 8192, 12288, rms.MAX_D]


def _block_rows_choices(rows):
    (space,) = kernel_space("rmsnorm", {"rows": rows, "D": 896})
    return space["choices"]


@pytest.mark.parametrize("rows", ROWS)
def test_grid_fills_a_wave_for_every_block_rows_choice(rows):
    """For every ``block_rows`` of the tuner's space: at least one wave of
    programs (or one a row, when there are fewer rows), never more than
    one wave, and every row covered by exactly one tile."""
    for D in (256, 896, 2560):
        for br in _block_rows_choices(rows):
            br = rms.effective_config(br, rows, D)["block_rows"]
            g = rms.geometry(rows, D, br, SMS)
            assert g["wave"] == SMS * rms.RESIDENT
            assert min(rows, g["wave"]) <= g["grid"] <= g["wave"], (rows, D, br, g)
            assert g["tile_rows"] <= br and g["tile_rows"] & (g["tile_rows"] - 1) == 0
            assert (g["tiles"] - 1) * g["tile_rows"] < rows <= g["tiles"] * g["tile_rows"]
            assert g["tile_rows"] == 1 or g["tile_rows"] * g["chunk"] <= rms.MAX_TILE_ELEMS
            assert 1 <= g["num_warps"] <= 8
            assert g["stages"] in (1, rms.STAGES)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("D", WIDTHS)
def test_pipeline_stages_fit_shared_memory(D, itemsize):
    """The pipeline stages a tile in shared memory only where its loads (a
    chunked row's twice) fit MAX_STAGED_BYTES."""
    for rows in (8, 4096, 65536):
        g = rms.geometry(rows, D, 256, SMS, itemsize)
        loads = g["tile_rows"] * g["chunk"] * g["n_chunks"] * itemsize
        staged = loads * (1 if g["n_chunks"] == 1 else 2)
        assert (g["stages"] > 1) == (staged <= rms.MAX_STAGED_BYTES), (rows, g)


@pytest.mark.parametrize("D", WIDTHS)
def test_chunks_cover_the_row(D):
    """A row up to MAX_CHUNK columns is one masked power-of-two chunk; a
    wider one is walked in chunks of MAX_CHUNK."""
    chunk, n = rms.col_chunks(D)
    assert chunk & (chunk - 1) == 0 and chunk <= rms.MAX_CHUNK and n <= rms.MAX_CHUNKS
    assert (n - 1) * chunk < D <= n * chunk
    assert n == 1 if D <= rms.MAX_CHUNK else chunk == rms.MAX_CHUNK
    assert {896: (1024, 1), 2560: (1024, 3), 4096: (1024, 4)}.get(D, (chunk, n)) == (chunk, n)


def test_default_geometry_at_the_served_and_trained_shapes():
    """rows = 8 * 512 (a prefill wave, a train batch) at d_model 896: the
    old default (256 rows a program) launched 16 programs on 132 SMs; now
    the grid is a full wave."""
    g = rms.geometry(4096, 896, 256, SMS)
    assert g["grid"] == SMS * rms.RESIDENT == 528 and g["tiles"] == 1024
    assert (g["tile_rows"], g["chunk"], g["num_warps"]) == (4, 1024, 8)
    assert rms.geometry(8, 896, 256, SMS)["grid"] == 8  # decode: a row a program


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [33, 896, 2560])
def test_plain_version_equals_the_oracle(dtype, D):
    x = torch.from_numpy(np.random.default_rng(D).standard_normal((5, 7, D)).astype(np.float32))
    s = torch.from_numpy(np.random.default_rng(1).standard_normal(D).astype(np.float32))
    x = x.to(dtype)
    got = rms.rmsnorm(x, s, 1e-6, block_rows=256)  # a CPU tensor: the plain version
    assert rms.rmsnorm.last_geometry is None and got.dtype == dtype
    torch.testing.assert_close(got, rms.rmsnorm_plain(x, s, 1e-6), rtol=0, atol=0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, s, 1e-6).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,D,distinct", [
    (4096, 128, 1), (4096, 896, 1), (65536, 512, 1), (65536, 896, 1), (65536, 4096, 1),
    (8448, 256, 2), (65536, 128, 3)])
def test_where_block_rows_changes_the_launch(rows, D, distinct):
    """``block_rows``' choices start at 8 rows, so the register cap and the
    wave rule bind first except at D <= 256 with rows for 16 waves: only
    there do two choices launch differently."""
    (space,) = kernel_space("rmsnorm", {"rows": rows, "D": D})
    geos = {tuple(sorted(rms.geometry(rows, D, rms.effective_config(br, rows, D)["block_rows"],
                                      SMS).items())) for br in space["choices"]}
    assert len(geos) == distinct
