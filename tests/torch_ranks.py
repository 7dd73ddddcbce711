"""One rank of the port's multi-rank CPU tests (gloo), started by
``tests/test_torch_distributed.py`` once per module:

    python tests/torch_ranks.py RANK WORLD STORE JOB OUT

``STORE`` is a ``FileStore`` path (no TCP port), ``JOB`` an ``.npz`` of the
inputs, ``OUT`` the directory this rank writes ``rank<RANK>.npz`` into:
  * ``distributed_cc_spanning_forest`` over ``"data"`` on a (WORLD,) mesh
    and on the (2, WORLD / 2) ``("data", "model")`` host mesh, for every
    graph of the job (``cc/<mesh>/<graph>/{rep,forest,rounds}``);
  * ``moe_block_shard_map`` on the (2, 4) mesh, with ``act_seq_axis``
    ``"model"`` and None: this rank's shards in, its output block out
    (``moe/<seq>/out``), and its routing of the data shard's tokens
    (``moe/<seq>/{local_e,pos,keep}``);
  * ``distribute_tensor`` of ``arange`` under each spec of ``SPECS`` on the
    (2, 4) mesh (``block/<i>``), and the rank's mesh coordinate.
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

#: Specs whose DTensor blocks are held against JAX's on the (2, 4) mesh.
SPECS = ((("data", "model"), None), ("model", "data"),
         (None, ("data", "model")), ("data", None))


def main(rank: int, world: int, store: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import distributed_cc_spanning_forest
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    data = np.load(job)
    res = {}
    line = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    grid = make_host_mesh(2, world // 2, device_type="cpu")
    res["coordinate"] = np.array(grid.get_coordinate())
    graphs = sorted({k.split("/")[1] for k in data if k.startswith("g/")})
    for label, mesh in (("line", line), ("grid", grid)):
        run = distributed_cc_spanning_forest(mesh, "data")
        for name in graphs:
            src = torch.from_numpy(data[f"g/{name}/src"])
            dst = torch.from_numpy(data[f"g/{name}/dst"])
            rep, forest, rounds = run(src, dst,
                                      n_nodes=int(data[f"g/{name}/n"]))
            res[f"cc/{label}/{name}/rep"] = rep.numpy()
            res[f"cc/{label}/{name}/forest"] = forest.numpy()
            res[f"cc/{label}/{name}/rounds"] = np.array(rounds)

    di, mi = (int(c) for c in grid.get_coordinate())
    x = torch.from_numpy(data["moe/x"])
    w = {k: torch.from_numpy(data[f"moe/{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    n_data, n_model = grid.shape
    e_per = w["w_gate"].shape[0] // n_model
    d = x.shape[2]

    def block(t, dim, i, n):
        size = t.shape[dim] // n
        return t.narrow(dim, i * size, size)

    wg = block(block(w["w_gate"], 0, mi, n_model), 1, di, n_data)
    wu = block(block(w["w_up"], 0, mi, n_model), 1, di, n_data)
    wd = block(block(w["w_down"], 0, mi, n_model), 2, di, n_data)
    xb = block(x, 0, di, n_data)
    for seq in ("model", None):
        cfg = dataclasses.replace(
            get_arch("moonshot-v1-16b-a3b").make_smoke_config(),
            dtype=torch.float32, act_batch_axes=("data",), act_seq_axis=seq,
            moe_expert_axis="model")
        xl = xb if seq is None else block(xb, 1, mi, n_model)
        y = tt.moe_block_shard_map(xl, w["router"], wg, wu, wd, cfg, grid)
        tag = f"moe/{seq}"
        res[f"{tag}/out"] = y.numpy()
        _g, le, pos, keep, cap = tt.moe_route_local(
            xb.reshape(-1, d), w["router"], cfg, mi, e_per)
        res[f"{tag}/local_e"] = le.numpy()
        res[f"{tag}/pos"] = pos.numpy()
        res[f"{tag}/keep"] = keep.numpy()
        res[f"{tag}/cap"] = np.array(cap)

    full = torch.arange(8 * 16, dtype=torch.int64).view(8, 16)
    for i, spec in enumerate(SPECS):
        sh = NamedSharding(grid, P(*spec))
        res[f"block/{i}"] = distribute_tensor(
            full, grid, sh.placements).to_local().numpy()
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
