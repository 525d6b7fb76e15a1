"""The port's CUDA kernels and models on the card, against their plain
PyTorch versions, and the device backend's CUDA graph against a
step-by-step loop. Marked `gpu`; they skip where there is no CUDA device.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of tests/test_kernels.py (fp32 2e-5, bf16 2e-2), with
TF32 off so that the fp32 plain versions take full fp32 products.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("s,d,dtype", [(128, 64, torch.float32),
                                       (256, 128, torch.float32),
                                       (128, 64, torch.bfloat16),
                                       (77, 16, torch.float32),
                                       (200, 256, torch.float32),
                                       (96, 256, torch.bfloat16),
                                       (256, 128, torch.bfloat16),
                                       (200, 128, torch.bfloat16),   # ragged S
                                       (300, 256, torch.bfloat16),
                                       (50, 16, torch.bfloat16)])    # bf16 on 3xTF32
@pytest.mark.parametrize("window,softcap,kv_heads", [(0, None, 2), (64, None, 1),
                                                     (0, 30.0, 2)])
def test_flash_attention_kernel(cuda, s, d, dtype, window, softcap, kv_heads):
    """Both routes of K1: bf16 at D 64/128/256 on wgmma, fp32 and bf16 at
    D 16 on 3xTF32 mma.sync; each launch counted under its route."""
    from repro_torch.kernels import flash_attention as tflash
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, h = 2, 2
    q = _rand(gen, (b, s, h, d), dtype, cuda)
    k, v = (_rand(gen, (b, s, kv_heads, d), dtype, cuda) for _ in range(2))
    before = ops.launch_counts()["flash_attention"]
    by_route = dict(tflash.flash_attention.launches_by_route)
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    want = ops.flash_attention_plain(q, k, v, window=window, softcap=softcap)
    assert ops.launch_counts()["flash_attention"] == before + 1
    route = tflash.route(dtype, d)
    assert route == ("wgmma" if dtype == torch.bfloat16 and d > 16 else "tf32x3")
    by_route[route] += 1
    assert tflash.flash_attention.launches_by_route == by_route
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("s,dtype,kv_heads", [(256, torch.float32, 4),
                                              (512, torch.bfloat16, 4),
                                              (333, torch.float32, 1),
                                              (512, torch.bfloat16, 2)])
def test_decode_attention_kernel(cuda, s, dtype, kv_heads):
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, h, d = 4, 4, 64
    q = _rand(gen, (b, h, d), dtype, cuda)
    k, v = (_rand(gen, (b, s, kv_heads, d), dtype, cuda) for _ in range(2))
    lens = torch.tensor([0, s // 4, s // 2, s], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    want = ops.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("h,kh,d,dtype", [(10, 1, 256, torch.float32),   # RecurrentGemma
                                          (10, 1, 256, torch.bfloat16),
                                          (20, 2, 256, torch.float32),
                                          (10, 1, 128, torch.float32)])
def test_decode_attention_kernel_head_blocks(cuda, h, kh, d, dtype):
    """Many query heads per kv head, all served by each split's one CTA of
    their kv head, at D 256 and D 128."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, s = 4, 576
    q = _rand(gen, (b, h, d), dtype, cuda)
    k, v = (_rand(gen, (b, s, kh, d), dtype, cuda) for _ in range(2))
    lens = torch.tensor([0, 1, 300, s], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lens)
    want = ops.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [[1], [16], [17], [0], [576], [1000], [32, 33]])
def test_decode_attention_kernel_split_edges(cuda, lens, dtype):
    """K2's split edges at RecurrentGemma's shape (10 query heads on one kv
    head of 256, a ring of 576; chunk 16 at 132 SMs): only split 0 live, a
    length at a chunk's edge and one past it, a length-0 row, a full ring
    and a length past S, at B 1 (the fewest CTAs) and B 2; one launch a
    call."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, s, h, kh, d = len(lens), 576, 10, 1, 256
    q = _rand(gen, (b, h, d), dtype, cuda)
    k, v = (_rand(gen, (b, s, kh, d), dtype, cuda) for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, ln)
    assert ops.launch_counts()["decode_attention"] == before + 1
    want = ops.decode_attention_plain(q, k, v, ln)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256])
def test_decode_attention_kernel_chunks(cuda, monkeypatch, chunk):
    """Every chunk K2's plan may pick, at qwen3's decode shape (B 4, S 512,
    40/8 heads, D 128, bf16), the plan picking it for an SM count other
    than the card's."""
    from repro_torch.kernels import decode_attention as tdecode
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, s, h, kh, d = 4, 512, 40, 8, 128
    sms = b * kh * (s // chunk) // 2
    assert tdecode.plan(b, s, h, kh, d, torch.bfloat16, sms)[0] == chunk
    monkeypatch.setattr(tdecode, "num_sms", lambda index: sms)
    q = _rand(gen, (b, h, d), torch.bfloat16, cuda)
    k, v = (_rand(gen, (b, s, kh, d), torch.bfloat16, cuda) for _ in range(2))
    ln = torch.tensor([0, 1, 264, 600], dtype=torch.int32, device=cuda)
    got = tdecode.decode_attention(q, k, v, ln)
    want = ops.decode_attention_plain(q, k, v, ln)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_decode_attention_kernel_smem_ceiling(cuda, d, dtype):
    """The most query heads on one kv head that K2's plan accepts at each
    (dtype, D) launch and agree with the plain version: the plan's shared
    memory rule and the kernel's own agree at the ceiling."""
    from repro_torch.kernels import decode_attention as tdecode
    sms = tdecode.num_sms(torch.device(cuda).index)

    def fits(g):
        try:
            tdecode.plan(2, 40, g, 1, d, dtype, sms)
        except ValueError:
            return False
        return True

    lo, hi = 1, 4096   # fits(lo), not fits(hi)
    assert fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    gen = torch.Generator(device=cuda).manual_seed(10)
    q = _rand(gen, (2, lo, d), dtype, cuda)
    k, v = (_rand(gen, (2, 40, 1, d), dtype, cuda) for _ in range(2))
    ln = torch.tensor([0, 33], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, ln)
    want = ops.decode_attention_plain(q, k, v, ln)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,w,out_dtype,with_h0", [
    (4, 512, 2560, torch.float32, False),     # the serving call
    (4, 512, 2560, torch.bfloat16, True),
    (2, 37, 200, torch.float32, True),        # ragged S and W
    (3, 5, 64, torch.float32, True),          # S shorter than one chunk
    (2, 4096, 256, torch.float32, True),      # S over 64 tiles: the carry between tiles
    (2, 4096, 256, torch.bfloat16, False),
    (1, 2049, 96, torch.bfloat16, True),      # ragged S over 33 tiles, B 1
    (1, 2049, 96, torch.float32, False),
    (3, 1, 37, torch.float32, True),          # S 1; W 37, not a multiple of the strip
    (3, 1, 37, torch.bfloat16, False),
    (1, 5, 37, torch.bfloat16, True),         # S under one chunk, B 1
    (2, 300, 20, torch.bfloat16, True),       # W under one strip
    (2, 300, 20, torch.float32, False),
])
def test_rglru_scan_kernel(cuda, b, s, w, out_dtype, with_h0):
    """K4 (a chunked scan over S) against its plain version: y within 1e-5
    of max|h| in fp32 (tests/test_kernels.py:78-86), within bf16's 2e-2
    when y is bf16; the last state (fp32) within 1e-5 of max|h| either
    way."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.sigmoid(_rand(gen, (b, s, w), torch.float32, cuda))
    bb = _rand(gen, (b, s, w), torch.float32, cuda) * 0.1
    h0 = _rand(gen, (b, w), torch.float32, cuda) if with_h0 else None
    before = ops.launch_counts()["rglru_scan"]
    y, h_last = ops.rglru_scan(a, bb, h0=h0, out_dtype=out_dtype)
    assert ops.launch_counts()["rglru_scan"] == before + 1
    yp, hp = ops.rglru_scan_plain(a, bb, h0=h0, out_dtype=out_dtype)
    assert y.dtype == out_dtype and h_last.dtype == torch.float32
    scale = max(float(yp.float().abs().max()), 1.0)
    tol = TOL[out_dtype] if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), yp.float(), atol=tol * scale, rtol=tol)
    torch.testing.assert_close(h_last, hp, atol=1e-5 * scale, rtol=1e-5)
    torch.testing.assert_close(h_last, yp[:, -1].float(), atol=TOL[out_dtype] * scale,
                               rtol=TOL[out_dtype])


@pytest.mark.parametrize("b,s,w", [(4, 512, 2560), (1, 2049, 96), (3, 1, 37)])
def test_rglru_scan_plan(cuda, b, s, w):
    """K4's plan, read from the built kernel, is its grid: a CTA for each
    strip of lw lanes (whole warps) of each batch row, walking S in tiles
    of t nc steps; at least one CTA fits an SM."""
    from repro_torch.kernels import rglru_scan as trglru
    p = trglru.plan(b, s, w)
    assert p["lw"] % 32 == 0 and p["t"] >= 1 and p["nc"] >= 1
    assert p["ctas"] == b * -(-w // p["lw"])
    assert p["tiles"] == -(-s // (p["t"] * p["nc"]))
    assert p["ctas_per_sm"] >= 1


def test_lm_on_card_matches_cpu(cuda):
    cfg = smoke_config("qwen3-14b")
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = bundle.init(0, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    want = greedy_generate(bundle, cpu, {"tokens": tokens}, 10, 64, torch.float32)
    ops.reset_launch_counts()
    got = greedy_generate(bundle, gpu, {"tokens": tokens.to(cuda)}, 10, 64, torch.float32)
    assert ops.launch_counts() == {"flash_attention": cfg.num_layers,
                                   "decode_attention": cfg.num_layers * 9, "ssd_scan": 0,
                                   "rglru_scan": 0, "flash_attention_bwd": 0,
                                   "ssd_scan_bwd": 0, "rglru_scan_bwd": 0}
    torch.testing.assert_close(got.cpu(), want)


@pytest.mark.parametrize("b,s,h,p,n,g,dtype,with_h0", [
    (2, 200, 4, 16, 32, 2, torch.float32, True),      # ragged S over 4 kernel chunks, G < H
    (1, 37, 2, 8, 16, 1, torch.float32, False),       # S shorter than one chunk
    (1, 130, 3, 80, 128, 3, torch.float32, True),     # two p tiles, G == H
    (2, 128, 4, 64, 128, 1, torch.bfloat16, False),   # the serving widths, bf16
    (2, 200, 4, 64, 128, 1, torch.bfloat16, True),    # ragged S, on the tensor cores
    (1, 37, 2, 64, 128, 1, torch.bfloat16, True),     # under one chunk
    (2, 256, 4, 64, 128, 2, torch.bfloat16, False),   # G 2 with H 4, no h0
    (1, 130, 3, 128, 64, 3, torch.bfloat16, True),    # B 1, N 64, two p tiles
    (2, 100, 4, 16, 32, 2, torch.bfloat16, True),     # bf16 at P 16: the CUDA cores
])
def test_ssd_scan_kernel(cuda, b, s, h, p, n, g, dtype, with_h0):
    """The three routes of K3 against its plain version (y and final
    state): bf16 with P a multiple of 64 and N 64 or 128 on the tensor
    cores by wgmma, fp32 on the 3xTF32 route, other bf16 widths on the CUDA
    cores, each launch counted under its route; in fp32 also the final
    state against the sequential oracle. atol
    is stated against max|y_ref|, as tests/test_kernels.py:73-75: 3e-5 in
    fp32, 2e-2 in bf16 (the plain version rounds the products C·Bᵀ and
    C·S_prevᵀ to bf16, the tensor-core route M and S_prev)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as tssd
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (_rand(gen, (b, s, h, p), torch.float32, cuda) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(_rand(gen, (b, s, h), torch.float32, cuda))
    a = -torch.exp(_rand(gen, (h,), torch.float32, cuda) * 0.3)
    bm, cm = ((_rand(gen, (b, s, g, n), torch.float32, cuda) * 0.3).to(dtype) for _ in range(2))
    h0 = _rand(gen, (b, h, p, n), torch.float32, cuda) * 0.2 if with_h0 else None
    before = ops.launch_counts()["ssd_scan"]
    by_route = dict(tssd.ssd_scan.launches_by_route)
    y, st = ops.ssd_scan(x, dt, a, bm, cm, h0=h0, return_state=True)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    route = tssd.route(dtype, p, n)
    assert route == ("tf32x3" if dtype == torch.float32
                     else "wgmma" if p % 64 == 0 else "cuda_cores")
    assert tssd.kernel_route(dtype, p, n) == route
    by_route[route] += 1
    assert tssd.ssd_scan.launches_by_route == by_route
    yp, sp = ops.ssd_scan_plain(x, dt, a, bm, cm, chunk=64, h0=h0)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    scale = max(float(yp.float().abs().max()), 1.0)
    torch.testing.assert_close(y.float(), yp.float(), atol=tol * scale,
                               rtol=1e-4 if dtype == torch.float32 else tol)
    torch.testing.assert_close(st, sp, atol=tol * max(float(sp.abs().max()), 1.0), rtol=1e-4)
    if dtype == torch.float32:
        rep = h // g
        _, sr = ref.ssd_ref(x, dt, a, bm.repeat_interleave(rep, 2), cm.repeat_interleave(rep, 2),
                            h0)
        torch.testing.assert_close(st, sr, atol=3e-5 * max(float(sr.abs().max()), 1.0),
                                   rtol=1e-4)


@pytest.mark.parametrize("s,skv,h,kh,d,dtype", [(256, 1024, 16, 16, 64, torch.bfloat16),
                                                 (300, 77, 4, 2, 128, torch.bfloat16),
                                                 (65, 129, 2, 2, 256, torch.bfloat16),
                                                 (12, 8, 4, 2, 16, torch.float32),
                                                 (33, 300, 2, 1, 128, torch.float32)])
def test_flash_attention_kv_len_kernel(cuda, s, skv, h, kh, d, dtype):
    """Both routes of K1 with k and v of a length of their own (the
    encoder-decoder's cross-attention, unmasked); a causal mask with such a
    length raises. Under autograd the fp32 call's gradients come from
    K1-bwd, held to autograd of the plain version; bf16 raises (no bf16
    K1 backward)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = _rand(gen, (2, s, h, d), dtype, cuda)
    k, v = (_rand(gen, (2, skv, kh, d), dtype, cuda) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    with pytest.raises(ValueError, match="no causal mask"):
        ops.flash_attention(q, k, v)
    if dtype != torch.float32:
        with pytest.raises(NotImplementedError, match="bf16 K1 backward"):
            ops.flash_attention(q.requires_grad_(), k, v, causal=False)
        return
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    do = _rand(gen, q.shape, dtype, cuda)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=False), leaves, do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    want = torch.autograd.grad(ops.flash_attention_plain(*leaves, causal=False), leaves, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_grad(g, w)


def test_encdec_on_card_matches_cpu(cuda):
    """seamless-m4t-large-v2 reduced: K1 carries the encoder's layers and
    the decoder's self- and cross-attention prefill (12 tokens over 8
    frames), K2 both decode calls a layer; the card's prefill logits and
    greedy tokens equal the CPU's in fp32."""
    cfg = smoke_config("seamless-m4t-large-v2")
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = bundle.init(0, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=gen),
             "frontend": torch.randn(2, cfg.frontend_tokens, cfg.frontend_dim, generator=gen)}
    on_card = {k: t.to(cuda) for k, t in batch.items()}
    want, _ = bundle.prefill(cpu, batch, max_len=32, dtype=torch.float32)
    got, _ = bundle.prefill(gpu, on_card, max_len=32, dtype=torch.float32)
    torch.testing.assert_close(got.logits.cpu(), want.logits, atol=1e-4, rtol=1e-4)
    want = greedy_generate(bundle, cpu, batch, 10, 32, torch.float32)
    ops.reset_launch_counts()
    got = greedy_generate(bundle, gpu, on_card, 10, 32, torch.float32)
    assert ops.launch_counts() == {"flash_attention": cfg.enc_layers + 2 * cfg.dec_layers,
                                   "decode_attention": 2 * cfg.dec_layers * 9,
                                   "ssd_scan": 0, "rglru_scan": 0,
                                   "flash_attention_bwd": 0, "ssd_scan_bwd": 0,
                                   "rglru_scan_bwd": 0}
    torch.testing.assert_close(got.cpu(), want)


def test_mamba_on_card_matches_cpu(cuda):
    """K3 carries every prefill layer (and no decode step); the card's
    greedy tokens equal the CPU's in fp32."""
    cfg = smoke_config("mamba2-2.7b")
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = bundle.init(0, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    want = greedy_generate(bundle, cpu, {"tokens": tokens}, 10, None, torch.float32)
    ops.reset_launch_counts()
    got = greedy_generate(bundle, gpu, {"tokens": tokens.to(cuda)}, 10, None, torch.float32)
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": cfg.num_layers, "rglru_scan": 0,
                                   "flash_attention_bwd": 0, "ssd_scan_bwd": 0,
                                   "rglru_scan_bwd": 0}
    torch.testing.assert_close(got.cpu(), want)


def test_recurrentgemma_on_card_matches_cpu(cuda):
    """K4 carries every recurrent layer's prefill, K1 (window 32 < the
    150-token prompt) and K2 (the ring, wrapped) the local layer's; the
    card's prefill logits and greedy tokens equal the CPU's in fp32."""
    from repro_torch.models.recurrentgemma import layer_kinds
    cfg = smoke_config("recurrentgemma-2b")
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = bundle.init(0, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    want, _ = bundle.prefill(cpu, {"tokens": tokens}, max_len=190, dtype=torch.float32)
    got, _ = bundle.prefill(gpu, {"tokens": tokens.to(cuda)}, max_len=190, dtype=torch.float32)
    torch.testing.assert_close(got.logits.cpu(), want.logits, atol=1e-4, rtol=1e-4)
    want = greedy_generate(bundle, cpu, {"tokens": tokens}, 10, 190, torch.float32)
    ops.reset_launch_counts()
    got = greedy_generate(bundle, gpu, {"tokens": tokens.to(cuda)}, 10, 190, torch.float32)
    n_rec = layer_kinds(cfg).count("rglru")
    n_att = cfg.num_layers - n_rec
    assert ops.launch_counts() == {"flash_attention": n_att, "decode_attention": n_att * 9,
                                   "ssd_scan": 0, "rglru_scan": n_rec,
                                   "flash_attention_bwd": 0, "ssd_scan_bwd": 0,
                                   "rglru_scan_bwd": 0}
    torch.testing.assert_close(got.cpu(), want)


@pytest.mark.parametrize("arch", ["gemma2-9b", "starcoder2-15b", "qwen2.5-32b",
                                  "internvl2-1b"])
def test_dense_family_on_card_matches_cpu(cuda, arch):
    """The rest of the dense family at its reduced configs: K1 once a layer
    in the prefill, K2 once a layer a decode step (gemma2's local layers
    with the window of 32 < the 150-token prompt and a wrapped ring, every
    logit capped); prefill logits and greedy tokens equal the CPU's in
    fp32."""
    cfg = smoke_config(arch)
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu")
    gpu = bundle.init(0, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    want, _ = bundle.prefill(cpu, {"tokens": tokens}, max_len=190, dtype=torch.float32)
    got, _ = bundle.prefill(gpu, {"tokens": tokens.to(cuda)}, max_len=190, dtype=torch.float32)
    torch.testing.assert_close(got.logits.cpu(), want.logits, atol=1e-4, rtol=1e-4)
    want = greedy_generate(bundle, cpu, {"tokens": tokens}, 10, 190, torch.float32)
    ops.reset_launch_counts()
    got = greedy_generate(bundle, gpu, {"tokens": tokens.to(cuda)}, 10, 190, torch.float32)
    assert ops.launch_counts() == {"flash_attention": cfg.num_layers,
                                   "decode_attention": cfg.num_layers * 9, "ssd_scan": 0,
                                   "rglru_scan": 0, "flash_attention_bwd": 0,
                                   "ssd_scan_bwd": 0, "rglru_scan_bwd": 0}
    torch.testing.assert_close(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kh,d,lens", [(333, 16, 8, 256, [0, 1, 129, 333]),
                                           (64, 4, 2, 16, [64, 7, 33, 1])])
def test_decode_attention_kernel_softcap(cuda, dtype, s, h, kh, d, lens):
    """K2 with gemma2's cap of 50, q scaled so that the cap bends the logits:
    against its plain version, which differs from the uncapped one."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = (_rand(gen, (len(lens), h, d), torch.float32, cuda) * 40).to(dtype)
    k, v = (_rand(gen, (len(lens), s, kh, d), dtype, cuda) for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, ln, softcap=50.0)
    want = ops.decode_attention_plain(q, k, v, ln, softcap=50.0)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    uncapped = ops.decode_attention_plain(q, k, v, ln)
    assert float((uncapped.float() - want.float()).abs().max()) > TOL[dtype]


# ---- the backward kernels (K1-bwd, K4-bwd) and the training path ----------

GRAD_TOL = 1e-4   # of the largest |gradient| of a tensor, and relative


def _close_grad(got, want):
    """Gradients agree within GRAD_TOL of the tensor's largest |value|: dK
    and dV each sum up to S * H / KH products, K4-bwd a chain of S FMAs, in
    another order than the plain versions take."""
    scale = max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, atol=GRAD_TOL * scale, rtol=GRAD_TOL)


@pytest.mark.parametrize("b,s,h,kh,d,kw", [
    (4, 256, 10, 1, 256, {"window": 2048}),     # RecurrentGemma's training call
    (2, 200, 5, 1, 128, {}),                      # qwen3's 5 query heads a kv head, ragged S
    (2, 150, 4, 1, 16, {"window": 32}),           # RecurrentGemma reduced config
    (2, 77, 4, 2, 64, {"softcap": 30.0}),
    (2, 300, 10, 1, 256, {"window": 100}),        # window < S
    (1, 40, 4, 4, 16, {"causal": False}),
    # the tensor-core tiles' edges (32 rows by 32 keys): one past a tile, one
    # past two, ragged over ten; a window ending inside a key tile; D 16
    (2, 33, 4, 2, 64, {}),
    (1, 65, 10, 1, 256, {"window": 20}),
    (2, 300, 4, 1, 128, {"window": 45}),
    (2, 65, 4, 2, 16, {"window": 7}),
    (1, 33, 2, 1, 16, {"causal": False, "softcap": 5.0}),
])
def test_flash_attention_backward_kernel(cuda, b, s, h, kh, d, kw):
    """K1 in fp32 under autograd: its forward writes each row's log-sum-exp,
    and K1-bwd's dq, dk, dv match the plain backward's formulas and
    autograd of the plain forward; one launch of each a call."""
    from repro_torch.kernels import flash_attention as tflash
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = _rand(gen, (b, s, h, d), torch.float32, cuda).requires_grad_()
    k, v = (_rand(gen, (b, s, kh, d), torch.float32, cuda).requires_grad_() for _ in range(2))
    do = _rand(gen, (b, s, h, d), torch.float32, cuda)
    kw = {"causal": True, **kw}
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    o, lse = tflash.flash_attention(q.detach(), k.detach(), v.detach(), return_lse=True, **kw)
    torch.testing.assert_close(lse, ops.flash_attention_lse_plain(q.detach(), k.detach(), **kw),
                               atol=2e-5, rtol=2e-5)
    plain = ops.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do, **kw)
    auto = torch.autograd.grad(ops.flash_attention_plain(q, k, v, **kw), (q, k, v), do)
    for g, p, a in zip(got, plain, auto):
        _close_grad(g, p)
        _close_grad(g, a)


def test_flash_attention_backward_refuses_misaligned(cuda):
    """K1-bwd copies q, k, v and do in 16-byte pieces: a tensor that starts
    off a 16-byte boundary (a contiguous view at an odd offset) is refused
    before any launch."""
    from repro_torch.kernels import flash_attention as tflash
    b, s, h, d = 1, 32, 2, 16
    q = torch.randn(b * s * h * d + 1, device=cuda)[1:].view(b, s, h, d)
    k = torch.randn(b, s, h, d, device=cuda)
    o, lse = tflash.flash_attention(k, k, k, return_lse=True)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention_bwd(q, k, k, o, lse, k)


@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("s,h,kh,kw", [
    (256, 10, 1, {"window": 2048}),        # the train call's shape at B 2
    (77, 4, 2, {"softcap": 30.0}),          # ragged over 32-row tiles
    (300, 4, 1, {"window": 45}),            # a window ending inside a key tile
    (33, 2, 2, {"causal": False}),
])
def test_flash_attention_lse_kernel(cuda, d, s, h, kh, kw):
    """K1's 3xTF32 route at every head_dim: the output within 2e-5 and each
    row's log-sum-exp within 1e-5 of the plain versions; one launch, on the
    tf32x3 route."""
    from repro_torch.kernels import flash_attention as tflash
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _rand(gen, (2, s, h, d), torch.float32, cuda)
    k, v = (_rand(gen, (2, s, kh, d), torch.float32, cuda) for _ in range(2))
    kw = {"causal": True, **kw}
    ops.reset_launch_counts()
    out, lse = tflash.flash_attention(q, k, v, return_lse=True, **kw)
    assert tflash.flash_attention.launches_by_route == {"wgmma": 0, "tf32x3": 1}
    torch.testing.assert_close(out, ops.flash_attention_plain(q, k, v, **kw),
                               atol=TOL[torch.float32], rtol=TOL[torch.float32])
    torch.testing.assert_close(lse, ops.flash_attention_lse_plain(q, k, **kw), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("d,kw", [(256, {"window": 2048}), (128, {}), (64, {"softcap": 30.0}),
                                  (16, {"window": 7})])
def test_flash_attention_bwd_from_tf32x3_lse(cuda, d, kw):
    """K1-bwd fed by the 3xTF32 forward's output and log-sum-exp: dq, dk
    and dv within 1e-4 of each gradient's max of the plain backward fed by
    the plain forward's, and of autograd of the plain forward."""
    from repro_torch.kernels import flash_attention as tflash
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, s, h, kh = 2, 96, 4, 1
    q = _rand(gen, (b, s, h, d), torch.float32, cuda)
    k, v = (_rand(gen, (b, s, kh, d), torch.float32, cuda) for _ in range(2))
    do = _rand(gen, (b, s, h, d), torch.float32, cuda)
    kw = {"causal": True, **kw}
    o, lse = tflash.flash_attention(q, k, v, return_lse=True, **kw)
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    o_plain = ops.flash_attention_plain(q, k, v, **kw)
    lse_plain = ops.flash_attention_lse_plain(q, k, **kw)
    plain = ops.flash_attention_bwd_plain(q, k, v, o_plain, lse_plain, do, **kw)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(ops.flash_attention_plain(qa, ka, va, **kw), (qa, ka, va), do)
    for g, p, a in zip(got, plain, auto):
        _close_grad(g, p)
        _close_grad(g, a)


def test_flash_attention_tf32x3_refuses_misaligned(cuda):
    """The 3xTF32 route copies q, k and v in 16-byte pieces: a view that
    starts off a 16-byte boundary is refused before any launch."""
    from repro_torch.kernels import flash_attention as tflash
    b, s, h, d = 1, 32, 2, 16
    q = torch.randn(b * s * h * d + 1, device=cuda)[1:].view(b, s, h, d)
    k = torch.randn(b, s, h, d, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        tflash.flash_attention(q, k, k)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("b,s,w,out_dtype,with_h0", [
    (4, 256, 2560, torch.float32, False),      # RecurrentGemma's training call
    (2, 300, 37, torch.float32, True),
    (1, 5, 100, torch.bfloat16, True),
    (3, 1, 64, torch.float32, True),
    # the chunked walk's edges (tiles of 64 steps, strips of 32 lanes): S over
    # many tiles, ragged; S 1 at W 37; B 1 under one strip
    (2, 4096, 256, torch.float32, True),
    (1, 2049, 96, torch.float32, False),
    (1, 1, 37, torch.float32, True),
    (1, 300, 20, torch.float32, False),
])
def test_rglru_scan_backward_kernel(cuda, b, s, w, out_dtype, with_h0):
    """K4 under autograd keeps its fp32 h and K4-bwd's da, db, dh0 match the
    plain reverse recurrence and autograd of the plain forward."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    a = torch.sigmoid(_rand(gen, (b, s, w), torch.float32, cuda) + 2.0).requires_grad_()
    bb = (_rand(gen, (b, s, w), torch.float32, cuda) * 0.1).requires_grad_()
    h0 = _rand(gen, (b, w), torch.float32, cuda).requires_grad_() if with_h0 else None
    dy = _rand(gen, (b, s, w), torch.float32, cuda)
    dh = _rand(gen, (b, w), torch.float32, cuda)
    ins = (a, bb) + ((h0,) if with_h0 else ())
    ops.reset_launch_counts()
    y, h_last = ops.rglru_scan(a, bb, h0=h0, out_dtype=out_dtype)
    assert y.dtype == out_dtype
    got = torch.autograd.grad((y.float() * dy).sum() + (h_last * dh).sum(), ins)
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == 1 and counts["rglru_scan_bwd"] == 1
    yp, _ = ops.rglru_scan_plain(a.detach(), bb.detach(),
                                 h0=None if h0 is None else h0.detach())
    plain = ops.rglru_scan_bwd_plain(a.detach(), yp, None if h0 is None else h0.detach(),
                                     dy if out_dtype == torch.float32 else dy.bfloat16().float(),
                                     dh)
    y2, h2 = ops.rglru_scan_plain(a, bb, h0=h0)
    auto = torch.autograd.grad((y2.to(out_dtype).float() * dy).sum() + (h2 * dh).sum(), ins)
    for g, p, q in zip(got, plain, auto):
        _close_grad(g, p)
        _close_grad(g, q)


@pytest.mark.parametrize("b,s,w", [(4, 256, 2560), (1, 1, 37), (2, 4096, 256)])
def test_rglru_scan_backward_plan(cuda, b, s, w):
    """K4-bwd's plan from the built kernel: a CTA a strip of lanes of one
    batch row, S in tiles of chunks, and at least one CTA an SM."""
    from repro_torch.kernels import rglru_scan as trglru
    p = trglru.bwd_plan(b, s, w)
    assert p["lw"] % 32 == 0 and p["ctas_per_sm"] >= 1
    assert p["tiles"] == -(-s // (p["t"] * p["nc"]))
    assert p["ctas"] == b * -(-w // p["lw"])


def test_kernels_without_a_backward_refuse_grad(cuda):
    """K1's bf16 route, K2 and K3 in bf16 raise under autograd on the card
    rather than return a tensor with no grad_fn; under no_grad they run."""
    q = torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="bf16 K1 backward"):
        ops.flash_attention(q, q, q)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    kv = torch.randn(1, 32, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        ops.decode_attention(kv[:, 0], kv, kv, torch.ones(1, dtype=torch.int32, device=cuda))
    x = torch.randn(1, 16, 2, 16, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    dt = torch.rand(1, 16, 2, device=cuda)
    bm = torch.randn(1, 16, 1, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bf16 K3 backward"):
        ops.ssd_scan(x, dt, -torch.ones(2, device=cuda), bm, bm)


@pytest.mark.parametrize("b,s,h,p,g,n,with_h0,with_dstate", [
    (4, 256, 80, 64, 1, 128, False, False),   # mamba2-2.7b's train call
    (2, 200, 4, 16, 2, 32, True, True),       # ragged S, G < H, h0, d(final state)
    (1, 37, 2, 80, 2, 128, True, False),      # under one chunk, two p tiles
    (2, 150, 16, 8, 1, 16, False, True),      # the reduced config
])
def test_ssd_scan_backward_kernel(cuda, b, s, h, p, g, n, with_h0, with_dstate):
    """K3 in fp32 under autograd runs K3 and K3-bwd; the gradients of x, dt,
    a, b, c and h0 match the plain backward and autograd of the plain
    forward within GRAD_TOL of each one's max."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (_rand(gen, (b, s, h, p), torch.float32, cuda) * 0.5).requires_grad_()
    dt = torch.nn.functional.softplus(_rand(gen, (b, s, h), torch.float32, cuda) - 1.0)
    a = -torch.exp(_rand(gen, (h,), torch.float32, cuda) * 0.5 + 1.0)
    bm, cm = ((_rand(gen, (b, s, g, n), torch.float32, cuda) * 0.3) for _ in range(2))
    h0 = _rand(gen, (b, h, p, n), torch.float32, cuda) * 0.2 if with_h0 else None
    ins = [x, dt.requires_grad_(), a.requires_grad_(), bm.requires_grad_(), cm.requires_grad_()]
    ins += [h0.requires_grad_()] if with_h0 else []
    dy = _rand(gen, (b, s, h, p), torch.float32, cuda)
    ds = _rand(gen, (b, h, p, n), torch.float32, cuda) if with_dstate else None
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(*ins[:5], h0=h0, return_state=True)
    loss = (y * dy).sum() + (0 if ds is None else (st * ds).sum())
    got = torch.autograd.grad(loss, ins)
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    plain = ops.ssd_scan_bwd_plain(*(t.detach() for t in ins[:5]),
                                   None if h0 is None else h0.detach(), dy, ds)
    y2, st2 = ops.ssd_scan_plain(*ins[:5], chunk=64, h0=h0)
    auto = torch.autograd.grad((y2 * dy).sum() + (0 if ds is None else (st2 * ds).sum()), ins)
    for g_, p_, a_ in zip(got, plain, auto):
        _close_grad(g_, p_)
        _close_grad(g_, a_)


@pytest.mark.parametrize("b,s,h,p,n,g,with_h0,with_dstate", [
    (4, 256, 80, 64, 128, 1, False, False),   # the train call
    (4, 256, 80, 64, 128, 1, True, True),     # with h0 and d(final state)
    (2, 200, 4, 16, 32, 2, True, True),       # ragged S, G < H
    (1, 37, 2, 80, 128, 2, True, False),      # under one chunk, two p tiles
    (1, 64, 3, 64, 64, 3, False, True),       # G == H, one whole chunk, N 64
    (2, 150, 16, 8, 16, 1, False, True),      # the reduced config
])
def test_ssd_scan_bwd_tf32x3_kernel(cuda, b, s, h, p, n, g, with_h0, with_dstate):
    """K3-bwd on its 3xTF32 chunk-parallel kernels, at ``chip_smoke.py``'s
    six K3-bwd cases, against its plain version within GRAD_TOL of each
    gradient's max; two calls give the same bits (every sum in one fixed
    order, no atomics)."""
    from repro_torch.kernels import ssd_scan as tssd
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = _rand(gen, (b, s, h, p), torch.float32, cuda) * 0.5
    dt = torch.nn.functional.softplus(_rand(gen, (b, s, h), torch.float32, cuda) - 2.0)
    a = -torch.exp(_rand(gen, (h,), torch.float32, cuda) * 0.5 + 1.0)
    bm, cm = ((_rand(gen, (b, s, g, n), torch.float32, cuda) * 0.3) for _ in range(2))
    h0 = _rand(gen, (b, h, p, n), torch.float32, cuda) * 0.2 if with_h0 else None
    dy = _rand(gen, (b, s, h, p), torch.float32, cuda)
    ds = _rand(gen, (b, h, p, n), torch.float32, cuda) if with_dstate else None
    ops.reset_launch_counts()
    got = tssd.ssd_scan_bwd(x, dt, a, bm, cm, h0, dy, ds)
    again = tssd.ssd_scan_bwd(x, dt, a, bm, cm, h0, dy, ds)
    assert ops.launch_counts()["ssd_scan_bwd"] == 2
    want = ops.ssd_scan_bwd_plain(x, dt, a, bm, cm, h0, dy, ds)
    assert (got[5] is None) == (h0 is None)
    for g_, a_, w_ in zip(got, again, want):
        if w_ is None:
            continue
        assert torch.equal(g_, a_)
        _close_grad(g_, w_)


def test_train_step_on_card_matches_cpu(cuda):
    """One V-trace AdamW step of the recurrentgemma smoke config through K1,
    K1-bwd, K4 and K4-bwd on the card: loss and grad_norm within 1e-4 of
    the CPU's (the plain versions under autograd), params within lr * 1e-2
    (AdamW's first step moves each by at most lr)."""
    from repro_torch.core.losses import init_train_state, make_train_step
    from repro_torch.envs.tokenworld import synthetic_vtrace_batch
    from repro_torch.optim import adamw
    from repro_torch.models.recurrentgemma import layer_kinds
    cfg = smoke_config("recurrentgemma-2b")
    bundle = make_model(cfg)
    lr = 1e-3
    opt = adamw(lr)
    step = make_train_step(bundle, opt)
    cpu = init_train_state(bundle, opt, seed=0, device="cpu")
    gpu = init_train_state(bundle, opt, seed=0, device=cuda)
    gpu["params"].load_state_dict(cpu["params"].state_dict())
    batch = synthetic_vtrace_batch(torch.Generator().manual_seed(3), 2, 48, cfg.vocab_size)
    cpu, m_cpu = step(cpu, batch)
    ops.reset_launch_counts()
    gpu, m_gpu = step(gpu, {k: t.to(cuda) for k, t in batch.items()})
    n_rec = layer_kinds(cfg).count("rglru")
    n_att = cfg.num_layers - n_rec
    assert ops.launch_counts() == {"flash_attention": n_att, "decode_attention": 0,
                                   "ssd_scan": 0, "rglru_scan": n_rec,
                                   "flash_attention_bwd": n_att, "ssd_scan_bwd": 0,
                                   "rglru_scan_bwd": n_rec}
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], atol=1e-4, rtol=1e-4)
    want = cpu["params"].state_dict()
    for name, p in gpu["params"].state_dict().items():
        torch.testing.assert_close(p.cpu(), want[name], atol=lr * 1e-2, rtol=0)


def _host_loop(env, policy, lanes, steps, seed):
    """The device engine's streams stepped one call at a time: the env's
    generator seeded `seed`, the action generator `action_generator(seed)`."""
    from repro_torch.rollout import action_generator
    gen = torch.Generator(device=env.device).manual_seed(seed)
    act = action_generator(seed, env.device)
    state, obs = env.reset(lanes, gen)
    out = {k: [] for k in ("obs", "actions", "rewards", "dones")}
    for _ in range(steps):
        actions, _ = policy(None, None, obs, act)
        out["obs"].append(obs)
        out["actions"].append(actions.to(torch.int32))
        state, obs, reward, done = env.step(state, actions, gen)
        out["rewards"].append(reward)
        out["dones"].append(done)
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def _random(num_actions):
    def policy_apply(params, core, obs, gen):
        return torch.randint(0, num_actions, (obs.shape[0],), generator=gen,
                             device=obs.device), core
    return policy_apply


@pytest.mark.parametrize("env_name", ["catch", "cartpole", "tokenworld"])
def test_device_engine_graph_replays_match_the_host_loop(cuda, env_name):
    """One capture; two replays after warmup equal the step-by-step loop on
    the card from the seed, and draw different actions."""
    import numpy as np

    from repro_torch.envs.cartpole import CartPoleEnv
    from repro_torch.envs.catch import CatchEnv
    from repro_torch.envs.tokenworld import TokenWorld
    from repro_torch.rollout import DeviceRolloutEngine
    env = {"catch": CatchEnv, "cartpole": CartPoleEnv, "tokenworld": TokenWorld}[env_name](
        device=cuda)
    policy = _random(env.num_actions)
    eng = DeviceRolloutEngine(env, policy, 64, 16, seed=3)
    eng.warmup(None)
    t1, t2 = eng.rollout(None), eng.rollout(None)
    ref = _host_loop(env, policy, 64, 32, 3)
    for k, want in ref.items():
        got = np.concatenate([t1[k], t2[k]])
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert eng.captures == 1 and not np.array_equal(t1["actions"], t2["actions"])


def test_device_engine_captures_while_another_thread_launches(cuda):
    """A worker captures at its first unroll while this thread keeps
    launching products on the card; a new params shape captures anew."""
    import time

    from repro_torch.envs.catch import CatchEnv
    from repro_torch.onpolicy import make_device_sampling_policy, mlp_actor_critic
    from repro_torch.rollout import DeviceRolloutEngine, RolloutWorker
    init_fn, apply_fn = mlp_actor_critic(50, 3)
    params = init_fn(torch.Generator().manual_seed(0), cuda)
    eng = DeviceRolloutEngine(CatchEnv(device=cuda), make_device_sampling_policy(apply_fn), 32,
                              8, seed=1, with_logprobs=True)
    w = RolloutWorker(0, eng, lambda t: None, lambda: (params, 0))
    x = torch.randn(256, 256, device=cuda)
    w.start()
    deadline = time.time() + 30
    while w.iterations < 5 and w.error is None and time.time() < deadline:
        x = torch.tanh(x @ x)
    w.stop()
    w.join(timeout=30)
    assert w.error is None, w.error
    assert eng.captures == 1 and w.iterations >= 5
    init_narrow, apply_narrow = mlp_actor_critic(50, 3, hidden=32)
    eng._policy = make_device_sampling_policy(apply_narrow)
    eng.rollout(init_narrow(torch.Generator().manual_seed(0), cuda))
    assert eng.captures == 2
