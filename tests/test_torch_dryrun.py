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
port. Then each kind of cell's record on both meshes: the cost analysis's
keys (``launch/cost_analysis.py``, held to the reference in
``tests/test_torch_cost_analysis.py``), its argument bytes equal to the
per-card bytes. Then the CLI: JSON a cell, ``--skip-existing``, and a
failing cell, after which no process group is left;
the CLI's cells take a stub analysis (a step on ``meta`` takes seconds a
cell, the records above run the real one).
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
from repro_torch.launch import cost_analysis, dryrun
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


COST_KEYS = {"flops", "bytes_accessed", "collective_bytes", "per_collective"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes"}


@pytest.mark.parametrize("multi_pod", (False, True),
                         ids=("16x16", "2x16x16"))
@pytest.mark.parametrize("arch,shape", [
    ("dien", "serve_p99"), ("dien", "train_batch"),
    ("llama3.2-1b", "decode_32k"), ("qwen3-1.7b", "long_500k"),
    ("gat-cora", "full_graph_sm"), ("schnet", "molecule")])
def test_cell_record_carries_cost(tmp_path, arch, shape, multi_pod):
    res = dryrun.run_cell(arch, shape, multi_pod=multi_pod, out_dir=tmp_path)
    assert not dist.is_initialized()
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(res["cost"]) == COST_KEYS
    assert set(res["memory_analysis"]) == MEMORY_KEYS
    mem, cost = res["memory_analysis"], res["cost"]
    assert mem["argument_size_in_bytes"] == res["bytes_per_device"]["total"]
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert cost["collective_bytes"] == sum(cost["per_collective"].values())
    assert set(cost["per_collective"]) <= set(cost_analysis.COLLECTIVE_OPS)
    assert mem["temp_size_in_bytes"] > 0
    assert mem["alias_size_in_bytes"] <= min(mem["output_size_in_bytes"],
                                             mem["argument_size_in_bytes"])
    if get_arch(arch).shapes[shape]["kind"] == "decode":
        # The cache is written in place: every input byte but the token
        # ids is aliased.
        batch = get_arch(arch).shapes[shape]["batch"]
        ids = res["bytes_per_device"]["inputs"] - mem["alias_size_in_bytes"]
        assert 0 < ids <= 4 * batch
    else:
        assert mem["alias_size_in_bytes"] == 0
    assert set(res["timings_s"]) == {"build", "analyze"}


def stub_analysis(_spec, _shape, _mesh, smoke=False):
    return {"cost": cost_analysis.OpCost(flops=1.0),
            "memory_analysis": dict.fromkeys(MEMORY_KEYS, 0)}


def test_cli_writes_json_and_skips(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(dryrun, "analyze_cell", stub_analysis)
    out = tmp_path / "dry"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--multi-pod", "--out", str(out)])
    res = json.loads((out / "llama3.2-1b__decode_32k__2x16x16.json")
                     .read_text())
    assert res["ok"] and res["n_devices"] == 512 and res["mesh"] == "2x16x16"
    assert res["bytes_per_device"]["total"] == sum(
        res["bytes_per_device"][g] for g in dryrun.GROUPS)
    assert set(res["timings_s"]) == {"build", "analyze"}
    assert res["cost"]["flops"] == 1.0 and "memory_analysis" in res
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
