"""gloo ranks on the CPU for the port's mesh tests.

:func:`spawn` starts ``world`` processes once, each joining a gloo group
over ``tcp://localhost``; every rank imports the test module that asked
(which imports torch and the port only at its top, never ``jax``), runs
its named scenario functions in order on a payload of numpy arrays, and
returns their results with the modules of the JAX package it loaded
(none). The parent holds them to the JAX reference.
"""
import datetime
import importlib
import socket
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

#: seconds a rank waits in a collective before its group gives up
RANK_TIMEOUT = 120


def _rank(rank, world, port, module, payload, scenarios, queue):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        mod = importlib.import_module(module)
        out = {}
        for name, fn, args in scenarios:
            out[name] = getattr(mod, fn)(payload, *args)
        out["loaded"] = sorted(n for n in sys.modules
                               if n.split(".")[0] in ("jax", "repro"))
        queue.put((rank, out))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn(world, module, payload, scenarios):
    """{rank: {scenario name: result, "loaded": [...]}} of ``world`` gloo
    ranks running ``scenarios`` ((name, function name in ``module``,
    extra args) in order); fails if a rank raised."""
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, module,
                                              payload, scenarios, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=4 * RANK_TIMEOUT)
                       for _ in range(world))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    for r, res in sorted(results.items()):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return results
