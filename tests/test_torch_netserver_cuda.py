"""The network front door on the card: a one-row and an 8-row request
over each framing return the same bytes as the front-end's own
``score`` of the same request (float32 scores, the engine's dtype and
bytes on the wire), and a served pipelined stream captures no graph
beyond the buckets it dispatches (each captured once, each replayed,
row 9's launches counted at replay).

Marked ``cuda``: skips without a GPU. This file imports neither jax nor
the JAX package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_netserver_cuda.py
"""

import asyncio

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import spmv
from photon_ml_tpu_torch.serving import (
    FrontendConfig,
    NetClient,
    NetServer,
    ServingFrontend,
)
from photon_ml_tpu_torch.serving import netserver, wire
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401

# The helpers of the serving card tests (a module beside this one: the
# tests directory is on the path, as for torch_threads).
import test_torch_serving_cuda as sc  # noqa: E402

TIMEOUT_S = 120.0
_threads_joined = sc._threads_joined


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the card")
    return torch.device("cuda")


def _frontend(gm):
    return ServingFrontend(
        {"default": gm}, dtype=torch.float32,
        ladder=sc.LADDER, device="cuda",
        config=FrontendConfig(coalesce_window_s=0.002, max_pending=4096))


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("framing", ["binary", "http"])
def test_wire_scores_are_the_frontends_bytes(cuda_device, framing, rows):
    gm = sc.model("all")
    fe = _frontend(gm)
    reqs = [sc.request(40 + i, rows) for i in range(3)]

    async def main():
        async with fe:
            want = [np.asarray(await fe.score(r)) for r in reqs]
            server = await NetServer(fe).start()
            try:
                async with NetClient("127.0.0.1", server.port,
                                     framing=framing) as c:
                    got = [await c.score(r) for r in reqs]
            finally:
                await server.close()
            return want, got, server.stats()

    want, got, st = run(main())
    for w, g, r in zip(want, got, reqs):
        assert w.dtype == g.dtype == np.float32 and g.shape == (rows,)
        assert w.tobytes() == g.tobytes()
        np.testing.assert_allclose(g, sc._host_scores(gm, r), rtol=0,
                                   atol=sc.HOST_ATOL)
    assert st["responses"] == 3 and st["wire_errors"] == {}


@pytest.mark.cuda
def test_pipelined_stream_captures_only_its_buckets(cuda_device):
    """200 one-row frames pipelined on four connections: every bucket the
    engine holds was dispatched (replayed) and captured once, graphs ==
    buckets, and row 9's launches are the replays' recorded launches plus
    those of each build's one eager run; a row's score is the bytes a
    request of it alone gets."""
    fe = _frontend(sc.model("all"))
    reqs = [sc.request(1000 + i, 1) for i in range(200)]

    async def main():
        async with fe:
            server = await NetServer(fe).start()
            spmv.reset_launch_counts()
            try:
                async def conn(part):
                    r, w = await asyncio.open_connection("127.0.0.1",
                                                         server.port)
                    try:
                        w.write(b"".join(netserver.encode_request(x)
                                         for x in part))
                        await w.drain()
                        return [await wire.read_binary_response(r)
                                for _ in part]
                    finally:
                        w.close()

                parts = [reqs[k::4] for k in range(4)]
                got = await asyncio.gather(*[conn(p) for p in parts])
                buckets = fe.engine("default").buckets()
                served = dict(
                    launches=spmv.csr_matvec.launches,
                    replays=sum(ex.replays for ex in buckets.values()),
                    builds=len(buckets), cache=fe.stats()["cache"])
                alone = [np.asarray(await fe.score(r)) for r in reqs[:10]]
            finally:
                await server.close()
            return parts, got, served, buckets, alone, server.stats()

    parts, got, served, buckets, alone, st = run(main())
    assert st["responses"] == 200 and st["wire_errors"] == {}
    assert served["cache"]["compilations"] == served["cache"]["entries"] \
        == served["builds"] > 0
    per = {ex.launches_per_replay for ex in buckets.values()}
    assert len(per) == 1
    lpr = per.pop()
    assert lpr > 0
    for ex in buckets.values():
        assert ex.graph is not None and ex.traces == 1 and ex.replays >= 1
    assert served["launches"] == (served["replays"] + served["builds"]) * lpr
    by_req = {id(x): s for part, scores in zip(parts, got)
              for x, s in zip(part, scores)}
    for r, a in zip(reqs[:10], alone):
        assert by_req[id(r)].tobytes() == a.tobytes()
