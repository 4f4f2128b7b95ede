"""The port's expert-parallel MoE (``moe_ffn_shardmap``) over gloo ranks,
against its dense dispatch.

Worker processes join a process group through a ``FileStore`` under
``tmp_path`` (no network), at worlds of 2 and 4, and run every case once;
the tests read their outputs. The reference's own expert-parallel test
fails on this image (``test_distributed.py::
test_expert_parallel_moe_matches_dense``), so the port is held to its
dense dispatch, which ``test_torch_moe.py`` holds to the reference's, and
in (b) to the reference's dense dispatch too. The moe layer is kimi-k2
reduced as the reference's test has it (``d_model=64, moe_d_ff=32,
n_experts=8, top_k=2``, one shared expert), float32, on an ``(8, 16, 64)``
batch split over the ranks by rows:

* (a) at ``capacity_factor=1.0`` (tokens are dropped on some rank), each
  rank's routing (expert, token, capacity slot, weight) is **Exact**
  against the dense dispatch on its own rows, and its output within
  ``OUT_TOL``; the aux loss is the mean over the ranks of the dense
  dispatch's aux on each rank's rows, within ``AUX_TOL``;
* (b) at ``capacity_factor=4.0`` (no drops), the gathered outputs within
  ``OUT_TOL`` of the dense dispatch on the gathered batch, and within
  2e-4 (the reference test's bound) of the reference's jitted
  ``moe_ffn``; the gradients of ``sum(out**2)`` through both exchanges,
  summed over the ranks (params) or gathered (inputs), within
  ``GRAD_TOL`` of the dense dispatch's, relative to the largest;
* at world 2: one ``make_train_step`` with ``moe_impl="expert_parallel"``
  against the same step with the dense dispatch (loss and params
  Bounded, the same on both ranks), ``make_prefill_step`` and
  ``make_serve_step`` with a mesh against their dense twins; and one
  ``make_train_step_approx`` step, which runs the dense dispatch (no
  exchange is made) and equals the dense config's step bit for bit.

Bounds: the expert matmuls run on ``(E / n, n * C, D)`` buffers against
the dense dispatch's ``(E, C, D)``, and (b) at another capacity, so rows
are summed by other BLAS kernels: float32 rounding only.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
OUT_TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-5
B, S = 8, 16

WORKER = textwrap.dedent('''
    import dataclasses, datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                         sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))

    from repro_torch.configs import get_config
    from repro_torch.core import prng as P, transport as T
    from repro_torch.core import channel as ch
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import registry as R
    from repro_torch.optim.sgd import sgd

    calls = [0]
    a2a = M._AllToAll.apply
    def counted(*a):
        calls[0] += 1
        return a2a(*a)
    M._AllToAll.apply = counted

    mesh = world_mesh()
    group = mesh.group
    res = {}
    base = get_config("kimi-k2-1t-a32b").reduced(
        d_model=64, moe_d_ff=32, n_experts=8, top_k=2)
    base = dataclasses.replace(base, n_shared_experts=1)
    x = np.random.default_rng(1).standard_normal((8, 16, 64)).astype(
        np.float32)
    b = 8 // world
    for tag, cf in (("a", 1.0), ("b", 4.0)):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        p = M.init_moe(P.PRNGKey(0), cfg, torch.float32)
        leaves = {k: v.requires_grad_() for k, v in p.items()
                  if k != "shared"}
        leaves["shared"] = {k: v.requires_grad_()
                            for k, v in p["shared"].items()}
        xl = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_()
        out, aux = M.moe_ffn_shardmap(xl, leaves, cfg, group)
        res[f"{tag}_out"] = out.detach().numpy()
        res[f"{tag}_aux"] = np.float32(aux.detach())
        C = M.capacity(b * 16, cfg)
        _, se, slot, tok, w, _ = M._local_dispatch(
            xl.detach().reshape(-1, 64), p, cfg, C)
        res[f"{tag}_route"] = np.stack([se.numpy(), tok.numpy(),
                                        slot.numpy()])
        res[f"{tag}_w"] = w.detach().numpy()
        if tag == "b":
            loss = torch.sum(out.to(torch.float32) ** 2)
            flat = [leaves[k] for k in ("router", "wi", "wg", "wo")] + [
                leaves["shared"][k] for k in ("wi", "wg", "wo")]
            grads = torch.autograd.grad(loss, flat + [xl])
            for k, g in zip(("router", "wi", "wg", "wo", "s_wi", "s_wg",
                             "s_wo", "x"), grads):
                res[f"b_grad_{k}"] = g.numpy()
    res["calls_moe"] = np.int64(calls[0])

    if world == 2:
        mcfg = get_config("phi3.5-moe-42b-a6.6b").reduced(dtype="float32")
        ep = dataclasses.replace(mcfg, moe_impl="expert_parallel")
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, mcfg.vocab_size, (4, 16)).astype(np.int32)
                 for k in ("tokens", "labels")}
        opt = sgd(0.5)
        tcfg = T.TransportConfig(channel=ch.ChannelConfig(snr_db=10.0),
                                 use_kernel=True)
        for name, c in (("ep", ep), ("dense", mcfg)):
            params = R.init_params(P.PRNGKey(0), c)
            before = calls[0]
            out = st.make_train_step(c, opt, mesh=mesh)(
                params, opt.init(params), batch, P.PRNGKey(6))
            res[f"train_{name}_calls"] = np.int64(calls[0] - before)
            leaves, _ = T.tree_flatten(out[0])
            res[f"train_{name}_params"] = torch.cat(
                [l.reshape(-1) for l in leaves]).numpy()
            res[f"train_{name}_loss"] = np.float32(out[2])
            before = calls[0]
            out = st.make_train_step_approx(c, opt, tcfg, mesh)(
                params, opt.init(params), batch, P.PRNGKey(6))
            res[f"approx_{name}_calls"] = np.int64(calls[0] - before)
            leaves, _ = T.tree_flatten(out[0])
            res[f"approx_{name}_params"] = torch.cat(
                [l.reshape(-1) for l in leaves]).numpy()
            local = {"tokens": torch.from_numpy(
                batch["tokens"][rank * 2:(rank + 1) * 2])}
            res[f"prefill_{name}"] = st.make_prefill_step(c, mesh)(
                params, local).numpy()
            cache = R.init_cache(c, 2, 4)
            tok, cache = st.make_serve_step(c, mesh=mesh)(
                params, cache, local["tokens"][:, :1], 0)
            res[f"serve_{name}_tok"] = tok.numpy()
            res[f"serve_{name}_k"] = cache["k"].numpy()
    np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()
''')


def _run_world(tmp, world):
    (tmp / "worker.py").write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(world),
         str(tmp / "store"), str(tmp / f"out{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run once, concurrently: ``{2: [rank outputs], 4:
    [...]}``."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(2) as ex:
        futs = {w: ex.submit(_run_world, tmp_path_factory.mktemp(f"w{w}"), w)
                for w in (2, 4)}
        return {w: f.result() for w, f in futs.items()}


def _cfg(cf):
    cfg = get_config("kimi-k2-1t-a32b").reduced(
        d_model=64, moe_d_ff=32, n_experts=8, top_k=2)
    return dataclasses.replace(cfg, capacity_factor=cf, n_shared_experts=1)


def _x():
    return np.random.default_rng(1).standard_normal((B, S, 64)).astype(
        np.float32)


def _params(cfg):
    return TM.init_moe(P.PRNGKey(0), cfg, torch.float32)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-30))


@pytest.mark.parametrize("world", [2, 4])
def test_local_routing_outputs_and_aux(worlds, world):
    """(a): drops; each rank against the dense dispatch on its rows."""
    cfg = _cfg(1.0)
    p, x = _params(cfg), _x()
    b = B // world
    auxes, drops = [], 0
    for r, res in enumerate(worlds[world]):
        xl = torch.from_numpy(x[r * b:(r + 1) * b])
        with torch.no_grad():
            out, aux = TM.moe_ffn(xl, p, cfg)
            _, se, slot, tok, w, _ = TM._local_dispatch(
                xl.reshape(-1, 64), p, cfg, TM.capacity(b * S, cfg))
        np.testing.assert_array_equal(
            res["a_route"], np.stack([se.numpy(), tok.numpy(),
                                      slot.numpy()]))
        np.testing.assert_array_equal(res["a_w"], w.numpy())
        assert _rel(res["a_out"], out.numpy()) <= OUT_TOL
        auxes.append(float(aux))
        drops += int((res["a_route"][2] == TM.capacity(b * S, cfg)).sum())
    assert drops > 0
    for res in worlds[world]:
        assert abs(float(res["a_aux"]) - np.mean(auxes)) <= AUX_TOL
    # two exchanges a call, each case once
    assert int(worlds[world][0]["calls_moe"]) == 4


@pytest.mark.parametrize("world", [2, 4])
def test_gathered_outputs_and_gradients(worlds, world):
    """(b): no drops; the ranks together against the dense dispatch on the
    gathered batch, and the outputs against the reference's."""
    cfg = _cfg(4.0)
    p, x = _params(cfg), _x()
    got = np.concatenate([r["b_out"] for r in worlds[world]])
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()
              if k != "shared"}
    leaves["shared"] = {k: v.clone().requires_grad_()
                        for k, v in p["shared"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = TM.moe_ffn(xt, leaves, cfg)
    assert _rel(got, out.detach().numpy()) <= OUT_TOL
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()), p)
    jout, _ = jax.jit(lambda x, p: JM.moe_ffn(x, p, cfg))(jnp.asarray(x), jp)
    np.testing.assert_allclose(got, np.asarray(jout), rtol=2e-4, atol=2e-4)
    flat = [leaves[k] for k in ("router", "wi", "wg", "wo")] + [
        leaves["shared"][k] for k in ("wi", "wg", "wo")]
    grads = torch.autograd.grad(torch.sum(out ** 2), flat + [xt])
    names = ("router", "wi", "wg", "wo", "s_wi", "s_wg", "s_wo")
    for k, g in zip(names, grads):
        summed = sum(r[f"b_grad_{k}"].astype(np.float64)
                     for r in worlds[world])
        assert np.isfinite(summed).all()
        assert _rel(summed, g.numpy()) <= GRAD_TOL, k
    gx = np.concatenate([r["b_grad_x"] for r in worlds[world]])
    assert _rel(gx, grads[-1].numpy()) <= GRAD_TOL


def test_train_step_at_world_2(worlds):
    """``make_train_step`` with the exchange against the dense dispatch;
    the per-client approx step makes no exchange and equals its dense
    twin bit for bit; prefill and serve against their dense twins."""
    r0, r1 = worlds[2]
    for res in (r0, r1):
        assert int(res["train_ep_calls"]) > 0
        assert int(res["train_dense_calls"]) == 0
        assert int(res["approx_ep_calls"]) == 0
        assert abs(float(res["train_ep_loss"])
                   - float(res["train_dense_loss"])) <= 1e-5
        assert _rel(res["train_ep_params"], res["train_dense_params"]) <= 1e-5
        np.testing.assert_array_equal(res["approx_ep_params"],
                                      res["approx_dense_params"])
        assert _rel(res["prefill_ep"], res["prefill_dense"]) <= OUT_TOL
        np.testing.assert_array_equal(res["serve_ep_tok"],
                                      res["serve_dense_tok"])
        assert _rel(res["serve_ep_k"], res["serve_dense_k"]) <= OUT_TOL
    np.testing.assert_array_equal(r0["train_ep_params"], r1["train_ep_params"])
    assert float(r0["train_ep_loss"]) == float(r1["train_ep_loss"])
