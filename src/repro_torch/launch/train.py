"""Training launcher: the V-trace LM-policy learner, end to end.

The port's counterpart of ``python -m repro.launch.train`` (one device: no
mesh, no sharding specs), with the same flags plus ``--device``, and the
same lines: ``step N loss X (ms/step)``, ``done``, ``final step: N``; on
the card also the peak device memory. The path is synthetic trajectories
-> background prefetch -> train step (forward, the V-trace loss, backward
through the kernels' backward kernels, AdamW) -> checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --smoke --device cpu --steps 6 --ckpt-dir /tmp/ck --ckpt-every 2 --fail-at 3

``--device`` defaults to cuda and raises where there is no card.
"""

import argparse
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, make_model, smoke_config
from repro_torch.core.losses import init_train_state, make_train_step
from repro_torch.data.pipeline import batch_iterator, prefetch
from repro_torch.device import dtype_of, resolve
from repro_torch.envs.tokenworld import synthetic_vtrace_batch
from repro_torch.launch.ft import SimulatedFailure, Supervisor
from repro_torch.optim import adamw, cosine_schedule


@dataclass
class Trainer:
    """What a run needs: the config, the model, the optimizer, the train
    step, and its batches and initial state, made from `seed`."""
    cfg: Any
    bundle: Any
    opt: Any
    train_step: Callable
    device: torch.device
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, i):
        """Step i's batch, on the device, from a generator seeded by (seed, i)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + i)
        return synthetic_vtrace_batch(gen, self.batch, self.seq, self.cfg.vocab_size)

    def make_state(self):
        return init_train_state(self.bundle, self.opt, self.seed, self.device)


def setup(arch, *, smoke=False, batch=4, seq=32, steps=20, lr=3e-4, device="cuda", seed=0,
          **overrides) -> Trainer:
    """The run of `arch` (its smoke config with `smoke`; `overrides` are
    config fields, e.g. num_layers), AdamW on the reference's cosine
    schedule (warm-up 10 steps, over max(steps, 20))."""
    dev = resolve(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    bundle = make_model(cfg)
    opt = adamw(cosine_schedule(lr, 10, max(steps, 20)),
                moment_dtype=dtype_of(cfg.optimizer_dtype))
    return Trainer(cfg, bundle, opt, make_train_step(bundle, opt), dev, batch, seq, seed)


def train_loop(run: Trainer, state, start, steps, *, ckpt=None, ckpt_every=0, fail_at=-1,
               injected=None, log=print):
    """Steps start .. steps - 1 on prefetched batches. Raises
    SimulatedFailure once at `fail_at` (`injected` remembers it across
    restarts); saves every `ckpt_every` steps and at the end. Returns
    (state, each step's metrics as device tensors)."""
    injected = {"done": False} if injected is None else injected
    it = prefetch(batch_iterator(run.batch_at, steps), size=2)
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(it):
        if i < start:
            continue
        if i == fail_at and not injected["done"]:
            injected["done"] = True
            raise SimulatedFailure(f"injected at step {i}")
        state, metrics = run.train_step(state, batch)
        history.append(metrics)
        if ckpt and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt.save(state, i + 1)
        if (i + 1) % 5 == 0 or i == 0:
            loss = float(metrics["loss"])
            dt = (time.perf_counter() - t0) / (i - start + 1)
            log(f"step {i + 1:4d} loss {loss:8.4f} ({dt * 1e3:.0f} ms/step)")
    if ckpt:
        ckpt.save(state, steps)
        ckpt.wait()
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (FT demo)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    run = setup(args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq, steps=args.steps,
                lr=args.lr, device=args.device)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    injected = {"done": False}

    def loop(state, start):
        state, _ = train_loop(run, state, start, args.steps, ckpt=ckpt,
                              ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                              injected=injected)
        return state

    if ckpt:
        sup = Supervisor(ckpt)
        state = sup.run(run.make_state, loop)
        print(f"done (restarts: {len(sup.restarts)})")
    else:
        state = loop(run.make_state(), 0)
        print("done")
    print("final step:", int(state["step"]))
    if run.device.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(run.device) / 1e9:.2f} GB")
    return state


if __name__ == "__main__":
    main()
