"""The port's training launcher (`repro_torch.launch.train`), on the CPU.

* ``--smoke`` trains: the loss falls over the run.
* Kill and resume: a run checkpointing every 2 steps, its newest
  checkpoint deleted (the kill), rerun with the same flags, restores the
  step before and gives the first run's losses bit for bit from there.
* The checkpoint holds (params, AdamW state) in the reference's layout:
  the params in the config's dtype, fp32 master and moments, the step.
* ``--mesh pod256|pod512`` raises on one process: the production mesh
  needs a process group of 256 / 512 ranks; the default device is CUDA,
  which raises here.
* An MoE arch trains under the 1 × 1 mesh through the expert-parallel path,
  as the reference's launcher does.
"""
import os
import shutil

import msgpack
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import train
from repro_torch.models import moe

torch.set_num_threads(1)

SMOKE = ["--smoke", "--batch", "2", "--seq", "64", "--log-every", "100"]


def _main(arch, steps, extra=()):
    return train.main(["--arch", arch, "--steps", str(steps), *SMOKE,
                       *extra], device="cpu")


def test_smoke_loss_falls_and_resumes_bit_for_bit(tmp_path, capsys):
    d = str(tmp_path / "ck")
    flags = ["--ckpt-dir", d, "--ckpt-every", "2"]
    first = _main("mamba2-780m", 8, flags)
    assert len(first) == 8 and np.isfinite(first).all()
    assert first[-1] < first[0]
    assert sorted(os.listdir(d)) == ["4", "6", "8"]
    with open(os.path.join(d, "8", "manifest.msgpack"), "rb") as f:
        arrays = msgpack.unpackb(f.read())["arrays"]
    dtypes = {a["name"].split("/")[0] + "/" + a["name"].split("/")[1]:
              a["dtype"] for a in arrays}
    assert dtypes["0/embed"] == get_config("mamba2-780m").reduced().dtype
    assert dtypes["1/master"] == dtypes["1/m"] == dtypes["1/v"] == "float32"
    assert dtypes["1/step"] == "int32"
    shutil.rmtree(os.path.join(d, "8"))          # the kill
    capsys.readouterr()
    second = _main("mamba2-780m", 8, flags)
    out = capsys.readouterr().out
    assert "restored step 6" in out and "final loss" in out
    assert second == first[6:]


def test_moe_trains_through_the_ep_path(monkeypatch):
    calls = []
    ep = moe.apply_moe_ep

    def counting(*a, **kw):
        calls.append(kw["batch_axes"])
        return ep(*a, **kw)
    monkeypatch.setattr(moe, "apply_moe_ep", counting)
    losses = _main("olmoe-1b-7b", 2)
    assert np.isfinite(losses).all() and len(losses) == 2
    assert calls and set(calls) == {("data",)}


def test_production_meshes_and_default_device_raise():
    with pytest.raises(RuntimeError, match="a process group of 256 ranks"):
        _main("mamba2-780m", 1, ["--mesh", "pod256"])
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "1"])
