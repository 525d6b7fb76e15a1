"""The port's quickstart (``repro_torch.launch.quickstart``): its LM part
alone on the CPU (the SEED demos spawn actor hosts, which the transport and
figure tests already cover)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import quickstart  # noqa: E402


def test_lm_demo_trains_restores_step_20_and_decodes(tmp_path):
    lines = []
    out = quickstart.lm_demo("qwen3-14b", device="cpu", out_dir=tmp_path, log=lines.append)
    assert out["restored_step"] == 20 and "  restored step 20" in lines
    assert len(out["losses"]) == 20 and all(torch.isfinite(torch.tensor(out["losses"])))
    assert out["generated"].shape == (2, 8) and out["generated"].dtype == torch.int32
    assert (tmp_path / "lm_ckpt" / "step_0000000020").is_dir()
