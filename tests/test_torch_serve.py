"""The port's slice entry points: qwen3-14b, mamba2-2.7b and
recurrentgemma-2b (reduced)
served to clients through the port's InferenceServer on the CPU, and the
default device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.launch import quickstart, serve_policy  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402

CFG = smoke_config("qwen3-14b")


def test_serve_policy_three_clients():
    clients, tokens = 3, 4
    out = serve_policy.serve(CFG, clients=clients, tokens=tokens, device="cpu",
                             deadline_ms=3.0)
    assert sorted(out["tokens"]) == list(range(clients))
    for toks in out["tokens"].values():
        assert len(toks) == tokens
        assert all(0 <= t < CFG.vocab_size for t in toks)
    st = out["stats"]
    assert st["requests"] == st["rpcs"] == clients * tokens
    # one decode step per batch: at least one per token, at most one per request
    assert tokens <= st["batches"] <= clients * tokens
    assert 0 < st["batch_occupancy"] <= st["batches"]
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


def test_full_batches_reproduce_greedy_generate():
    """With a deadline no client misses, every batch holds all clients, so
    each client's tokens are exactly its prompt's greedy continuation."""
    clients, tokens = 3, 5
    out = serve_policy.serve(CFG, clients=clients, tokens=tokens, device="cpu",
                             deadline_ms=60_000.0, seed=4)
    st = out["stats"]
    assert st["batches"] == tokens and st["batch_occupancy"] == tokens
    bundle = make_model(CFG)
    params = bundle.init(4, device="cpu", dtype=torch.float32)
    want = greedy_generate(bundle, params,
                           {"tokens": torch.from_numpy(out["prompts"])},
                           steps=tokens + 1, max_len=64, dtype=torch.float32)
    for cid in range(clients):
        assert out["first"][cid] == int(want[cid, 0])
        assert out["tokens"][cid] == want[cid, 1:].tolist()


def test_serve_main_prints_ok(capsys):
    serve_policy.main(["--device", "cpu", "--clients", "2", "--tokens", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == '{"ok": true}'


def test_serve_rejects_cache_overflow():
    with pytest.raises(ValueError, match="max_len"):
        serve_policy.serve(CFG, clients=4, tokens=16, prompt_len=8, max_len=64,
                           device="cpu")


@pytest.mark.parametrize("entry", ["serve", "init", "init_cache", "main", "quickstart"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Without device=, an entry point runs on the card, and raises where
    there is none: no silent fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = make_model(CFG)
    call = {"serve": lambda: serve_policy.serve(CFG, clients=1, tokens=1),
            "init": lambda: bundle.init(0),
            "init_cache": lambda: bundle.init_cache(1, 8),
            "main": lambda: serve_policy.main(["--clients", "1", "--tokens", "1"]),
            "quickstart": lambda: quickstart.main([])}
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        call[entry]()


def test_prompts_are_distinct_and_seeded():
    a = serve_policy.serve(CFG, clients=2, tokens=1, device="cpu", seed=9)
    b = serve_policy.serve(CFG, clients=2, tokens=1, device="cpu", seed=9)
    np.testing.assert_array_equal(a["prompts"], b["prompts"])
    assert not np.array_equal(a["prompts"][0], a["prompts"][1])
    assert a["tokens"] == b["tokens"]


def test_policy_failure_reaches_the_caller(monkeypatch):
    """A decode step that raises poisons the clients' replies, and serve()
    raises with the server's traceback instead of returning short lists."""
    def broken(bundle):
        def step(params, tokens_t, cache):
            raise ValueError("decode exploded")
        return step
    monkeypatch.setattr(serve_policy, "make_serve_step", broken)
    with pytest.raises(RuntimeError, match="decode exploded"):
        serve_policy.serve(CFG, clients=2, tokens=2, device="cpu")


def test_mamba_serve_reproduces_greedy_generate():
    """mamba2-2.7b (reduced) through the same server: its state cache
    ignores max_len, and full batches give each client its greedy tokens."""
    cfg = smoke_config("mamba2-2.7b")
    clients, tokens = 3, 4
    out = serve_policy.serve(cfg, clients=clients, prompt_len=20, tokens=tokens,
                             max_len=64, device="cpu", deadline_ms=60_000.0, seed=2)
    assert out["stats"]["batches"] == tokens
    bundle = make_model(cfg)
    params = bundle.init(2, device="cpu", dtype=torch.float32)
    want = greedy_generate(bundle, params, {"tokens": torch.from_numpy(out["prompts"])},
                           steps=tokens + 1, max_len=64, dtype=torch.float32)
    for cid in range(clients):
        assert [out["first"][cid]] + out["tokens"][cid] == want[cid].tolist()


def test_serve_main_mamba_prints_ok(capsys):
    serve_policy.main(["--arch", "mamba2-2.7b", "--device", "cpu", "--clients", "2",
                       "--tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("== mamba2-2.7b (reduced") and lines[-1] == '{"ok": true}'


def test_recurrentgemma_serve_reproduces_greedy_generate():
    """recurrentgemma-2b (reduced) through the same server: a 40-token
    prompt overflows the local layers' 32-slot rings, and full batches give
    each client its greedy tokens."""
    cfg = smoke_config("recurrentgemma-2b")
    clients, tokens = 3, 4
    out = serve_policy.serve(cfg, clients=clients, prompt_len=40, tokens=tokens,
                             max_len=64, device="cpu", deadline_ms=60_000.0, seed=3)
    assert out["stats"]["batches"] == tokens
    bundle = make_model(cfg)
    params = bundle.init(3, device="cpu", dtype=torch.float32)
    want = greedy_generate(bundle, params, {"tokens": torch.from_numpy(out["prompts"])},
                           steps=tokens + 1, max_len=64, dtype=torch.float32)
    for cid in range(clients):
        assert [out["first"][cid]] + out["tokens"][cid] == want[cid].tolist()


def test_serve_main_recurrentgemma_prints_ok(capsys):
    serve_policy.main(["--arch", "recurrentgemma-2b", "--device", "cpu", "--clients", "2",
                       "--tokens", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("== recurrentgemma-2b (reduced") and lines[-1] == '{"ok": true}'
