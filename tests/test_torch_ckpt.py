"""The port's checkpointing, restart supervision and train launcher, on
the CPU: ``CheckpointManager`` mirrors the JAX package's tests of async
failures (tests/test_fault.py), plus a round trip of a train state, the
keep policy, and the launcher's injected failure and restart."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager, restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.core.losses import init_train_state  # noqa: E402
from repro_torch.launch import ft, train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def _block_step(mgr: CheckpointManager, step: int):
    """Make the NEXT save of `step` fail: plant a plain FILE where the
    atomic-save staging directory must go (os.makedirs then raises)."""
    open(mgr._step_dir(step) + ".tmp", "w").close()


def test_async_save_failure_reraised_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = {"w": torch.arange(3.0)}
    mgr.save(state, 1)
    mgr.wait()
    assert mgr.saves == 1
    _block_step(mgr, 2)
    mgr.save(state, 2)                       # async thread fails silently...
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.save(state, 3)                   # ...and surfaces HERE
    # the failure is consumed: the manager keeps working afterwards
    mgr.save(state, 3)
    mgr.wait()
    assert mgr.latest_step() == 3
    template = {"w": torch.zeros(3)}
    restored, step = mgr.restore(template)
    assert step == 3 and torch.equal(restored["w"], state["w"])
    assert restored["w"] is template["w"]     # written into the template's tensor
    assert mgr.restores == 1


def test_async_save_failure_reraised_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _block_step(mgr, 1)
    mgr.save({"w": torch.zeros(2)}, 1)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()


def test_train_state_round_trip(tmp_path):
    """A whole train state (the model, bf16 moments, the int step) comes
    back bit-exact into a fresh state's tensors; the snapshot is taken at
    save(), so a later in-place update does not leak into it; a template
    of another structure is refused."""
    cfg = smoke_config("recurrentgemma-2b")
    bundle = make_model(cfg)
    opt = adamw(1e-3, moment_dtype=torch.bfloat16)
    state = init_train_state(bundle, opt, seed=1, device="cpu")
    for v in state["opt_state"]["v"].values():
        v.normal_()
    state["step"] = 7
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state, 7)
    want = {k: v.clone() for k, v in state["params"].state_dict().items()}
    with torch.no_grad():
        state["params"].embed.table.add_(1.0)     # after the snapshot
    mgr.wait()
    fresh = init_train_state(bundle, opt, seed=2, device="cpu")
    got, step = mgr.restore(fresh)
    assert step == 7 and got["step"] == 7 and isinstance(got["step"], int)
    assert got["params"] is fresh["params"]
    for k, v in got["params"].state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in got["opt_state"]["v"].items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, state["opt_state"]["v"][k])
    with pytest.raises(ValueError, match="leaves"):
        restore_pytree({"w": torch.zeros(1)}, mgr._step_dir(7))


def test_keep_policy_and_atomic_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, async_save=False)
    for step in (1, 2, 3, 4):
        mgr.save({"w": torch.full((2,), float(step)), "n": np.arange(3)}, step)
    assert mgr.all_steps() == [3, 4] and mgr.saves == 4
    # a crash mid-save leaves only a .tmp directory, which is not a checkpoint
    (tmp_path / "ck" / "step_0000000005.tmp").mkdir()
    assert mgr.latest_step() == 4
    got, step = mgr.restore({"w": torch.zeros(2), "n": np.zeros(3, np.int32)})
    assert step == 4 and torch.equal(got["w"], torch.full((2,), 4.0))
    assert got["n"].dtype == np.int32 and list(got["n"]) == [0, 1, 2]
    save_pytree({"a": [torch.ones(1), 2]}, str(tmp_path / "one"))
    assert restore_pytree({"a": [torch.zeros(1), 0]}, str(tmp_path / "one"))["a"][1] == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.zeros(2)})


def test_supervisor_budget():
    """The fault layer is the JAX package's, copied: a failing loop restarts
    within the budget and then gives up."""
    class NoCkpt:
        def latest_step(self):
            return None
    calls = []

    def loop(state, start):
        calls.append(start)
        raise ft.SimulatedFailure("boom")
    sup = ft.Supervisor(NoCkpt(), max_restarts=2)
    with pytest.raises(RuntimeError, match="restarts within window"):
        sup.run(dict, loop)
    assert calls == [0, 0, 0] and len(sup.restarts) == 3


def test_launcher_restarts_from_checkpoint(tmp_path, capsys):
    """--fail-at 3 with a checkpoint every 2 steps: the supervisor restores
    step 2, runs to the end and prints the reference's lines."""
    state = train.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
                        "--steps", "6", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                        "--ckpt-every", "2", "--fail-at", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    1 loss ") and out[0].endswith(" ms/step)")
    assert "step    5 loss " in out[1]
    assert out[-2:] == ["done (restarts: 1)", "final step: 6"]
    assert state["step"] == 6
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 4, 6]


def test_launcher_needs_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        train.main(["--arch", "recurrentgemma-2b", "--smoke", "--steps", "1"])
    train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps", "2",
                "--seq", "8"])
    assert capsys.readouterr().out.splitlines()[-2:] == ["done", "final step: 2"]
