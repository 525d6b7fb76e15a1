"""The port's attention ops (plain PyTorch versions on the CPU) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Mirrors the sweep of tests/test_kernels.py at its tolerances (fp32 2e-5,
bf16 2e-2), plus what the port adds: a ragged S, a length-0 decode row and
GQA caches that are not head-expanded.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("s,d,dtype", [(128, 64, "float32"),
                                       (256, 128, "float32"),
                                       (128, 64, "bfloat16")])
@pytest.mark.parametrize("window,softcap", [(0, None), (64, None), (0, 30.0)])
def test_flash_attention_plain_matches_pallas(s, d, dtype, window, softcap):
    b, h = 2, 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, [(b, s, h, d)] * 3, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                softcap=softcap, block_q=64, block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              softcap=softcap)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, d)
    _close(got, want, dtype)


def _fold(x):
    b, s, h, d = x.shape
    return jnp.moveaxis(x, 2, 1).reshape(b * h, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_gqa(dtype):
    """S = 77 (no block divides it) and 2 kv heads for 6 query heads: the
    oracle sees the head-expanded KV, the port the unexpanded one."""
    b, s, h, kh, d = 2, 77, 6, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        11, [(b, s, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    rep = lambda x: _fold(jnp.repeat(x, h // kh, axis=2))
    want = jref.attention_ref(_fold(jq), rep(jk), rep(jv), scale=0.1)
    got = ops.flash_attention(tq, tk, tv, scale=0.1)
    got = got.transpose(1, 2).reshape(b * h, s, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("s,dtype", [(256, "float32"), (512, "bfloat16")])
def test_decode_attention_plain_matches_pallas(s, dtype):
    b, h, d = 3, 4, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        5, [(b, h, d), (b, s, h, d), (b, s, h, d)], dtype)
    lens = np.array([s // 4, s // 2, s], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=128)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == TDT[dtype] and got.shape == (b, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_empty_row_ragged_gqa(dtype):
    """A length-0 row (the mean of all S cached V rows), a length past S, a
    ragged S = 200 and an unexpanded GQA cache (5 query heads per kv head,
    as qwen3-14b)."""
    b, s, h, kh, d = 4, 200, 10, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(b, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    lens = np.array([0, 1, 137, 999], np.int32)
    rep = lambda x: jnp.repeat(x, h // kh, axis=2)
    want = jref.decode_attention_ref(jq, rep(jk), rep(jv), jnp.asarray(lens))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, want, dtype)
    mean_v = tv[0].float().mean(0).repeat_interleave(h // kh, dim=0)
    torch.testing.assert_close(got[0].float(), mean_v, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: a CPU tensor is an error there,
    and the ops dispatch refuses inputs split across devices."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "rglru_scan": 0}
    meta = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.flash_attention(q, meta, q)


def test_wrappers_check_shapes_before_launch():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)     # 2 kv heads do not divide 3 q heads
    with pytest.raises(ValueError, match="do not match"):
        tflash.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 24),
                               torch.zeros(1, 8, 2, 24))
    with pytest.raises(ValueError, match="lengths"):
        tdecode.decode_attention(torch.zeros(2, 2, 16), torch.zeros(2, 8, 2, 16),
                                 torch.zeros(2, 8, 2, 16), torch.ones(2))


def test_build_paths_track_source_and_flags(monkeypatch, tmp_path):
    """A library is named by a hash of its source and flags, under
    build/kernels/ of the checkout, so an edited source is never served
    by a stale build; without nvcc, building raises instead of falling back."""
    from repro_torch.kernels import build
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    before = build.library_path("flash_attention")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("flash_attention") != before
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("decode_attention",))
