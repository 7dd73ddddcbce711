"""The port's training CLI, ``launch.train.main(argv, device="cpu")``, on the
CPU at the smoke configs: for each LM id, each GNN id and DIEN, 4 steps
with a checkpoint every 2, then a second call with ``--steps 6`` that
resumes at 4 (and a third with ``--steps 4`` that resumes at 4, runs
nothing and holds the first call's state bit-equal), the reference's
report lines, through the cell on the host mesh (a world-1 gloo group
that ``main`` starts and destroys); the full-shape cells whose state and
inputs exceed one card on that mesh (dbrx-132b's, the decode_32k KV
caches) raise, naming their bytes a card, and those that fit (llama's
train_4k, moonshot's prefill_32k, ogb_products) pass the check, which
reads the dry run's bytes on ``meta`` (nothing is built)."""
import re

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.launch.mesh import host_mesh_session
from repro_torch.train import checkpoint as ckpt
from test_torch_transformer import one_torch_thread  # noqa: F401 (autouse)

STEP_LINE = re.compile(r"^step +(\d+)  loss (-?\d+\.\d{4})  \d+ ms$")
DONE_LINE = re.compile(r"^done: (\d+) steps in \d+\.\d+s; retries=0 "
                       r"stragglers=\d+$")


def _main(capsys, tmp_path, arch, steps):
    loop = train.main(["--arch", arch, "--smoke", "--steps", str(steps),
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)],
                      device="cpu")
    lines = capsys.readouterr().out.splitlines()
    return loop, lines


@pytest.mark.parametrize("arch", ["gat-cora", "schnet", "dimenet",
                                  "meshgraphnet", "dien", "minicpm-2b",
                                  "llama3.2-1b", "qwen3-1.7b",
                                  "moonshot-v1-16b-a3b", "dbrx-132b"])
def test_main_smoke_runs_and_resumes(capsys, tmp_path, arch):
    loop, lines = _main(capsys, tmp_path, arch, 4)
    assert loop.step == 4 and loop.retries == 0
    steps = [int(STEP_LINE.match(ln).group(1)) for ln in lines[:-1]]
    assert steps == [1] and DONE_LINE.match(lines[-1])
    assert int(DONE_LINE.match(lines[-1]).group(1)) == 4
    assert ckpt.latest_step(tmp_path / arch) == 4
    first = {k: p.detach().clone()
             for k, p in loop.state["params"].named_parameters()}

    loop, lines = _main(capsys, tmp_path, arch, 6)
    assert loop.step == 6
    assert [int(STEP_LINE.match(ln).group(1)) for ln in lines[:-1]] == [5]
    assert ckpt.latest_step(tmp_path / arch) == 6
    assert int(loop.state["opt"]["step"]) == 6
    assert all(torch.isfinite(p).all()
               for p in loop.state["params"].parameters())

    # Resuming at 4 with --steps 4 runs nothing: the checkpoint of step 4
    # is the first call's state, bit for bit.
    (tmp_path / arch / "step_0000000006").rename(tmp_path / "kept")
    loop, lines = _main(capsys, tmp_path, arch, 4)
    assert loop.step == 4 and len(lines) == 1
    got = dict(loop.state["params"].named_parameters())
    assert list(got) == list(first)
    for k, t in first.items():
        assert got[k].requires_grad and torch.equal(got[k].detach(), t), k


def test_main_refuses_what_is_not_ported(tmp_path):
    for arch, shape in (("dbrx-132b", None), ("dbrx-132b", "long_500k"),
                        ("qwen3-1.7b", "decode_32k"),
                        ("moonshot-v1-16b-a3b", "decode_32k")):
        argv = ["--arch", arch, "--ckpt-dir", str(tmp_path)]
        with pytest.raises(NotImplementedError,
                           match=r"GB a card on the 1x1 mesh .* exceed one "
                                 r"card's 80\.0 GB"):
            train.main(argv + (["--shape", shape] if shape else []),
                       device="cpu")
        assert not dist.is_initialized()
    with host_mesh_session("cpu") as mesh:
        for arch, shape in (("llama3.2-1b", "train_4k"),
                            ("moonshot-v1-16b-a3b", "prefill_32k"),
                            ("gat-cora", "ogb_products")):
            got = train.check_fits(get_arch(arch), shape, mesh,
                                   torch.device("cpu"))
            assert 0 < got <= train.CARD_BYTES, (arch, shape, got)
    assert not dist.is_initialized()
