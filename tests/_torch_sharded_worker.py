"""One rank of the sharded coded forms' CPU test (tests/test_torch_sharded.py).

Spawned once per rank: joins a gloo group through a ``FileStore``, builds a
(data=1, model=world) ``DeviceMesh``, runs ``coded_matmul_sharded`` and
``coded_conv2d_sharded`` on every case of the inputs file and writes its
results to ``rank<r>.npz``.  Imports torch and the port only (no JAX).
"""
from __future__ import annotations

import numpy as np


def rank_main(rank: int, world: int, store_path: str, inputs: str,
              out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import (ConvSpec, coded_conv2d_sharded,
                                  coded_matmul_sharded)
    from repro_torch.core import schemes

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        data = np.load(inputs)
        out = {}
        for key in sorted(k for k in data.files if k.endswith(":x")):
            case = key[:-2]
            op, name, k = case.split("-")
            cls = schemes.get_scheme(name)
            code = (cls.make(world) if name in ("replication", "uncoded")
                    else cls.make(world, int(k)))
            x = torch.from_numpy(data[case + ":x"])
            w = torch.from_numpy(data[case + ":w"])
            if op == "matmul":
                y = coded_matmul_sharded(x, w, code, mesh)
            else:
                spec = ConvSpec(*(int(v) for v in data[case + ":spec"]))
                y = coded_conv2d_sharded(x, w, code, spec, mesh)
            out[case] = y.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
