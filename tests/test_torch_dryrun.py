"""``launch/dryrun.py`` in the port against the reference's cells on the
CPU.

For every (arch, shape) cell on both production meshes, the port's
per-card bytes (state and inputs built on ``meta`` by ``build_cell``, each
placed by the sharding rules under a fake process group of 256 or 512
ranks) equal the sum, over the reference's ``build_cell`` trees (its
``jax.eval_shape`` leaves with their ``NamedSharding`` over a
``jax.sharding.AbstractMesh`` of the same shape), of each leaf's bytes
divided by its spec's shard counts, group by group (parameters, AdamW
state, inputs). The one difference is the KV cache's ``len``: the
reference's int32 scalar (4 bytes on every card) is a host int in the
port. Then the CLI: JSON a cell, ``--skip-existing``, and a failing cell,
after which no process group is left.
"""
import json

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh as JMesh

from repro.configs import get_arch as jax_get_arch
from repro.train.step import build_cell as jax_build_cell
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def ref_bytes(tree) -> tuple:
    """(per-card, global) bytes of a tree of sharded ShapeDtypeStructs."""
    local = total = 0
    for leaf in jax.tree.leaves(tree):
        size = np.dtype(leaf.dtype).itemsize
        local += size * int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
        total += size * int(np.prod(leaf.shape))
    return local, total


@pytest.mark.parametrize("multi_pod", (False, True),
                         ids=("16x16", "2x16x16"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bytes_match_reference(arch, multi_pod):
    shape, names = MESHES[multi_pod]
    jmesh = JMesh(shape, names)
    spec = get_arch(arch)
    for shape_name in spec.shapes:
        _step, state, inputs = jax_build_cell(jax_get_arch(arch), shape_name,
                                              jmesh)
        if isinstance(state, dict) and set(state) == {"params", "opt"}:
            want = {"params": ref_bytes(state["params"]),
                    "opt": ref_bytes(state["opt"])}
        else:
            want = {"params": ref_bytes(state), "opt": (0, 0)}
        want["inputs"] = ref_bytes(inputs)
        if "cache" in inputs:
            want["inputs"] = tuple(b - 4 for b in want["inputs"])
        with dryrun.fake_world(int(np.prod(shape))):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            got = dryrun.cell_bytes(spec, shape_name, mesh)
        assert not dist.is_initialized()
        for group in dryrun.GROUPS:
            assert got["bytes_per_device"][group] == want[group][0], \
                (shape_name, group)
            assert got["bytes_global"][group] == want[group][1], \
                (shape_name, group)
        host = ["inputs.cache.len"] if "cache" in inputs else []
        assert got["host_leaves"] == host


def test_cli_writes_json_and_skips(tmp_path, capsys):
    out = tmp_path / "dry"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--multi-pod", "--out", str(out)])
    res = json.loads((out / "llama3.2-1b__decode_32k__2x16x16.json")
                     .read_text())
    assert res["ok"] and res["n_devices"] == 512 and res["mesh"] == "2x16x16"
    assert res["bytes_per_device"]["total"] == sum(
        res["bytes_per_device"][g] for g in dryrun.GROUPS)
    assert set(res["timings_s"]) == {"build"}
    capsys.readouterr()
    dryrun.main(["--all", "--single-pod-only", "--skip-existing", "--out",
                 str(out)])
    text = capsys.readouterr().out
    assert "all 40 cells OK" in text and text.count("[ok]") == 40
    dryrun.main(["--all", "--multi-pod-only", "--skip-existing", "--out",
                 str(out)])
    text = capsys.readouterr().out
    assert "[skip] llama3.2-1b__decode_32k__2x16x16" in text
    assert text.count("[ok]") == 39
    assert len(list(out.glob("*.json"))) == 80
    assert not dist.is_initialized()


def test_failing_cell_leaves_no_group(tmp_path, monkeypatch, capsys):
    def broken(*_a, **_k):
        raise RuntimeError("broken cell")
    monkeypatch.setattr(dryrun, "cell_bytes", broken)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "dien", "--shape", "serve_p99", "--out",
                     str(tmp_path)])
    assert "[FAIL] dien__serve_p99__16x16" in capsys.readouterr().out
    res = json.loads((tmp_path / "dien__serve_p99__16x16.json").read_text())
    assert res["ok"] is False and "broken cell" in res["error"]
    assert not dist.is_initialized()
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="another one"):
            with dryrun.fake_world(4):
                pass
    assert not dist.is_initialized()
