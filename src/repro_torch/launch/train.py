"""Training launcher (port of `repro/launch/train.py`).

``--mesh cpu`` (the default), the reference's degenerate 1 × 1 mesh, runs
on ``device`` under that mesh (so an MoE layer takes the expert-parallel
path over one rank, as in the reference). ``--mesh pod256|pod512`` builds
the production mesh (`launch.mesh.make_production_mesh`) over the current
process group, which must have 256 or 512 ranks (else it raises): call
`main` on every rank (each with its own ``device``); every rank draws the
same weights from seed 0, places them and the AdamW state on the mesh by
their logical axes (`sharding.distribute_tree`) and runs the sharded step;
``--ckpt-dir`` is one-device only (it raises on a production mesh).
``--smoke`` trains the config's reduced form. With ``--ckpt-dir`` the run
checkpoints (params, optimizer state) every ``--ckpt-every`` steps through
`ckpt.checkpoint` (the step is the checkpoint's), and a rerun with the
same flags resumes from the newest checkpoint.

    python -m repro_torch.launch.train --arch mamba2-780m --smoke \\
        --steps 50 --batch 8 --seq 128

runs on the card; ``main([...], device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import InputShape, get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.sharding import distribute_tree, use_mesh
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def main(argv=None, *, device="cuda"):
    """Run the launcher; returns the losses of the steps it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the local device")
    ap.add_argument("--mesh", default="cpu", choices=["cpu", "pod256",
                                                      "pod512"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.mesh == "cpu":
        mesh = mesh_mod.make_cpu_mesh()
    else:
        mesh = mesh_mod.make_production_mesh(
            multi_pod=(args.mesh == "pod512"))
        if args.ckpt_dir:
            raise NotImplementedError(
                f"--ckpt-dir on --mesh {args.mesh}: checkpoints of sharded "
                "params are not written")

    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    with use_mesh(mesh):
        params = M.init_params(cfg, 0, device=dev)
        if args.mesh != "cpu":
            params = distribute_tree(params, M.param_axes(cfg), mesh)
        ostate = opt.init_adamw(ocfg, params)
        step_fn = make_train_step(cfg, ocfg, remat=False, device=dev)

        shape = InputShape("cli", args.seq, args.batch, "train")
        start = 0
        if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
            (params, ostate), start = checkpoint.restore(
                args.ckpt_dir, (params, ostate))
            print(f"restored step {start}")

        losses = []
        t0 = time.time()
        for step in range(start, args.steps):
            batch = make_batch(cfg, shape, step)
            params, ostate, metrics = step_fn(params, ostate, batch)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"({dt / max(step - start + 1, 1):.2f} s/step)")
            if (args.ckpt_dir and args.ckpt_every
                    and (step + 1) % args.ckpt_every == 0):
                checkpoint.save(args.ckpt_dir, step + 1, (params, ostate))
        print(f"final loss {losses[-1]:.4f} "
              f"(start {losses[0]:.4f}, drop {losses[0] - losses[-1]:.4f})")
        return losses


if __name__ == "__main__":
    main()
