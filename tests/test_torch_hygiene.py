"""The port stands alone: no JAX and nothing of ``repro`` in ``repro_torch``
or ``chip_smoke.py``; entry points never drop to the CPU on their own."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_importing_the_port_loads_no_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


#: The packages the card machine is documented to have beyond the standard
#: library (no JAX; nothing can be installed there).
CARD_PACKAGES = {"torch", "numpy", "scipy", "triton", "einops", "repro_torch"}


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_only_what_the_card_machine_has(path):
    """Every import of the port and of ``chip_smoke.py`` is the standard
    library or a package the card machine is documented to have (so no
    msgpack: a checkpoint's manifest is JSON)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top in sys.stdlib_module_names or top in CARD_PACKAGES, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"

def test_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.core import Graph, resolve_device, rooted_spanning_tree
    from repro_torch.data import graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([(0, 1), (1, 2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Graph.from_numpy_undirected(3, edges)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphs.chain(5)
    g = Graph.from_numpy_undirected(3, edges, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rooted_spanning_tree(g, 0)
    assert rooted_spanning_tree(g, 0, device="cpu").parent.tolist() == [0, 0, 1]

    from repro_torch.data.streams import churn
    from repro_torch.dynamic import forest_empty, init_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forest_empty(3, 4)
    stream = churn(g, batch=2, n_batches=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(stream)
    assert forest_empty(3, 4, device="cpu").parent.device.type == "cpu"
    assert init_state(stream, device="cpu").rep.tolist() == [0, 0, 2]

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.dien import dien_forward, dien_init
    from repro_torch.train.step import build_cell
    spec = get_arch("dien")
    cfg = spec.make_smoke_config()
    for name in ("serve_p99", "retrieval_cand"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_cell(spec, name, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batches(spec, spec.shapes["serve_p99"], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dien_init(cfg, generator=torch.Generator())
    step, params, _ = build_cell(spec, "serve_p99", smoke=True, device="cpu")
    _, batch = next(synthetic_batches(spec, {"kind": "serve", "batch": 4},
                                      cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dien_forward(cfg, params, batch)
    assert dien_forward(cfg, params, batch, device="cpu").shape == (4,)
    assert step(params, batch).shape == (4,)


def test_use_kernel_true_on_cpu_raises_through_the_entry_point():
    from repro_torch.core import Graph, rooted_spanning_tree
    g = Graph.from_numpy_undirected(3, np.array([(0, 1), (1, 2)]),
                                    device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        rooted_spanning_tree(g, 0, use_kernel=True, device="cpu")
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.train.step import build_cell
    spec = get_arch("dien")
    step, params, _ = build_cell(spec, "serve_p99", smoke=True, device="cpu",
                                 use_kernel=True)
    _, batch = next(synthetic_batches(spec, {"kind": "serve", "batch": 4},
                                      spec.make_smoke_config(), device="cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        step(params, batch)


def test_kernel_build_needs_nvcc_and_stays_under_build(monkeypatch,
                                                      tmp_path):
    from repro_torch.kernels import build
    gitignore = (ROOT / ".gitignore").read_text().splitlines()
    assert "build/" in gitignore
    for name in build.KERNELS:
        assert build.source(name).exists()
        assert build.library_path(name).is_relative_to(ROOT / "build")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


@pytest.mark.parametrize("name,symbol", [
    ("pointer_jump", "pointer_jump_double"),
    ("list_rank", "list_rank_double"),
    ("pointer_jump", "pointer_jump_double_stepwise"),
    ("list_rank", "list_rank_double_stepwise"),
    ("hook_edges", "hook_edges"),
    ("pointer_jump", "pointer_jump_chain"),
    ("list_rank", "list_rank_chain"),
    ("pointer_jump", "pointer_jump_chain_previous"),
    ("list_rank", "list_rank_chain_previous"),
    ("frontier_relax", "frontier_relax"),
    ("frontier_relax", "bfs_level"),
    ("segment_table", "segment_table"),
    ("segment_table", "segment_table_stepwise"),
    ("segment_table", "segment_table_launches"),
    ("embed_bag", "embed_bag"),
    ("embed_bag", "embed_bag_previous")])
def test_ctypes_signatures_match_the_c_entries(name, symbol):
    """Each C entry's ``argtypes`` (``ops._ARGTYPES[symbol]``) has one
    entry per parameter, pointers and the stream as ``c_void_p`` (a
    narrower type would cut a 64-bit pointer)."""
    import ctypes
    import importlib
    import re
    from repro_torch.kernels import build
    src = build.source(name).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"no C entry {symbol} in {build.source(name)}"
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = importlib.import_module(
        f"repro_torch.kernels.{name}.ops")._ARGTYPES[symbol]
    assert len(argtypes) == len(params)
    for param, ctype in zip(params, argtypes):
        if "*" in param:
            assert ctype is ctypes.c_void_p, param
        elif param.startswith("int64_t"):
            assert ctype is ctypes.c_int64, param
        else:
            assert param.startswith("int ") and ctype is ctypes.c_int, param
    assert 'extern "C" const char* kernel_error_string(int code)' in src
