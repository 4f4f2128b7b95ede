"""The port's launch layer across two ranks (``torch.distributed``, gloo on
the CPU), against the port's and the reference's unsharded paths.

Two worker processes join a process group through a ``FileStore`` under
``tmp_path`` (no network) and run every distributed case once; the tests
read their outputs. Each worker imports the port only. Grades:

* **Exact**: ``shard_transmit_batch`` (layered PHY, the kernel path's
  plain K1, per-client SNR) and ``shard_transmit_batch_adaptive`` equal
  the port's unsharded ``transmit_batch[_adaptive]`` and the reference's,
  bit for bit (received words and ``TxStats``) — against the reference's
  *unsharded* calls, since its sharded adaptive path fails on jax 0.9.0
  (ROADMAP Queue 3); ``approx_allreduce`` equals the mean over the ranks
  of the reference's ``transmit_pytree(local_r, fold_in(key, r))``,
  computed unsharded (two ranks: the sum of two float32 values halved,
  exact in both packages).
* One ``make_train_step_approx`` step and one per-shard step at world 2
  run, give finite losses, and leave the same params on both ranks.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
M, D = 4, 2500
TIMEOUT = 240

WORKER = textwrap.dedent('''
    import datetime, sys
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
    from repro_torch.core import aggregation as agg, channel as ch
    from repro_torch.core import prng as P, transport as T
    from repro_torch.launch import sharding as sh, steps as st
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.models import registry as R
    from repro_torch.optim.sgd import sgd

    mesh = world_mesh()
    res = {}
    x = np.random.default_rng(0).uniform(-0.9, 0.9, (4, 2500)).astype(
        np.float32)
    cases = {
        "layered": (T.TransportConfig(channel=ch.ChannelConfig(snr_db=10.0)),
                    None),
        "kernel": (T.TransportConfig(channel=ch.ChannelConfig(snr_db=10.0),
                                     use_kernel=True), None),
        "snr": (T.TransportConfig(channel=ch.ChannelConfig(snr_db=10.0)),
                np.array([4.0, 9.0, 14.0, 20.0], np.float32)),
    }
    for name, (cfg, snr) in cases.items():
        xh, s = sh.shard_transmit_batch(torch.from_numpy(x), P.PRNGKey(3),
                                        cfg, mesh, snr_db=snr, device="cpu")
        res[f"tb_{name}_x"] = xh.numpy()
        res[f"tb_{name}_err"] = s.bit_errors.numpy()
        res[f"tb_{name}_sym"] = s.data_symbols.numpy()
    cfgs = (T.TransportConfig(channel=ch.ChannelConfig(snr_db=12.0),
                              use_kernel=True),
            T.TransportConfig(modulation="16qam",
                              channel=ch.ChannelConfig(snr_db=12.0)),
            T.TransportConfig(mode="naive",
                              channel=ch.ChannelConfig(snr_db=12.0)))
    xh, s = sh.shard_transmit_batch_adaptive(
        torch.from_numpy(x), P.PRNGKey(8), cfgs, np.array([0, 1, 2, 1]),
        mesh, device="cpu")
    res["ad_x"], res["ad_err"] = xh.numpy(), s.bit_errors.numpy()
    res["ad_mode"], res["ad_sym"] = s.mode_idx.numpy(), s.data_symbols.numpy()

    rng = np.random.default_rng(100 + rank)
    local = {"b": torch.from_numpy(rng.uniform(-1, 1, (700,)).astype(
                 np.float32)),
             "a": {"w": torch.from_numpy(rng.uniform(-0.1, 0.1, (30, 50))
                                         .astype(np.float32))}}
    cfg = T.TransportConfig(channel=ch.ChannelConfig(snr_db=10.0))
    red, s = agg.approx_allreduce(local, P.PRNGKey(5), cfg, mesh.group)
    res["ar_a_w"], res["ar_b"] = red["a"]["w"].numpy(), red["b"].numpy()
    res["ar_err"] = s.bit_errors.numpy()

    mcfg = get_config("qwen2-1.5b").reduced(n_layers=2, d_model=64, d_ff=128,
                                            vocab_size=128, dtype="float32")
    opt = sgd(0.5)
    batch = {"tokens": np.random.default_rng(1).integers(0, 128, (4, 16))
             .astype(np.int32),
             "labels": np.random.default_rng(2).integers(0, 128, (4, 16))
             .astype(np.int32)}
    for name, step in (
            ("approx", st.make_train_step_approx(mcfg, opt, cfg, mesh)),
            ("shard", st.make_train_step(mcfg, opt, transport_cfg=cfg,
                                         mesh=mesh))):
        params = R.init_params(P.PRNGKey(0), mcfg)
        out = step(params, opt.init(params), batch, P.PRNGKey(6))
        leaves, _ = T.tree_flatten(out[0])
        res[f"{name}_params"] = torch.cat([l.reshape(-1) for l in leaves]
                                          ).numpy()
        res[f"{name}_loss"] = np.float32(out[2])
    np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two workers once; ``[rank0 outputs, rank1 outputs]``."""
    tmp = tmp_path_factory.mktemp("dist")
    (tmp / "worker.py").write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(WORLD),
         str(tmp / "store"), str(tmp / f"out{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
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
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _payload():
    return np.random.default_rng(0).uniform(-0.9, 0.9, (M, D)).astype(
        np.float32)


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


CASES = {"layered": (dict(), None), "kernel": (dict(use_kernel=True), None),
         "snr": (dict(), np.array([4.0, 9.0, 14.0, 20.0], np.float32))}


@pytest.mark.parametrize("name", list(CASES))
def test_shard_transmit_batch_exact(ranks, name):
    kw, snr = CASES[name]
    x = _payload()
    tcfg = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=10.0), **kw)
    th, ts = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(3), tcfg,
                               snr_db=snr, device="cpu")
    jcfg = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=10.0), **kw)
    jh, js = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(3), jcfg,
                               snr_db=None if snr is None else jnp.asarray(snr))
    for r in ranks:
        np.testing.assert_array_equal(_u32(r[f"tb_{name}_x"]), _u32(th.numpy()))
        np.testing.assert_array_equal(_u32(r[f"tb_{name}_x"]), _u32(jh))
        np.testing.assert_array_equal(r[f"tb_{name}_err"], ts.bit_errors.numpy())
        np.testing.assert_array_equal(r[f"tb_{name}_err"],
                                      np.asarray(js.bit_errors))
        np.testing.assert_array_equal(r[f"tb_{name}_sym"],
                                      np.asarray(js.data_symbols))
    assert ranks[0][f"tb_{name}_err"].sum() > 0


def test_shard_transmit_batch_adaptive_exact(ranks):
    """The kernel row is cleared, the cohort runs the select dispatch: the
    unsharded adaptive call on the cleared table, bit for bit."""
    x, mode = _payload(), np.array([0, 1, 2, 1])
    kws = (dict(use_kernel=True), dict(modulation="16qam"),
           dict(mode="naive"))
    tcfgs = TT.clear_kernel_rows(tuple(
        TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=12.0), **k)
        for k in kws))
    jcfgs = JT.clear_kernel_rows(tuple(
        JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=12.0), **k)
        for k in kws))
    th, ts = TT.transmit_batch_adaptive(torch.from_numpy(x), P.PRNGKey(8),
                                        tcfgs, mode, dispatch="select",
                                        device="cpu")
    jh, js = JT.transmit_batch_adaptive(jnp.asarray(x), jax.random.PRNGKey(8),
                                        jcfgs, mode, dispatch="bucketed")
    for r in ranks:
        np.testing.assert_array_equal(_u32(r["ad_x"]), _u32(th.numpy()))
        np.testing.assert_array_equal(_u32(r["ad_x"]), _u32(jh))
        np.testing.assert_array_equal(r["ad_err"], np.asarray(js.bit_errors))
        np.testing.assert_array_equal(r["ad_sym"], np.asarray(js.data_symbols))
        np.testing.assert_array_equal(r["ad_mode"], mode)


def test_approx_allreduce_exact(ranks):
    want = {"a_w": 0.0, "b": 0.0}
    errs = []
    for r in range(WORLD):
        rng = np.random.default_rng(100 + r)
        local = {"b": jnp.asarray(rng.uniform(-1, 1, (700,)).astype(np.float32)),
                 "a": {"w": jnp.asarray(rng.uniform(-0.1, 0.1, (30, 50))
                                        .astype(np.float32))}}
        cfg = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=10.0))
        got, st = JT.transmit_pytree(
            local, jax.random.fold_in(jax.random.PRNGKey(5), r), cfg)
        want["a_w"] = want["a_w"] + np.asarray(got["a"]["w"], np.float32)
        want["b"] = want["b"] + np.asarray(got["b"], np.float32)
        errs.append(float(st.bit_errors))
    for r, out in enumerate(ranks):
        for k in want:
            np.testing.assert_array_equal(
                _u32(out[f"ar_{k}"]), _u32((want[k] / np.float32(WORLD))
                                           .astype(np.float32)))
        assert float(out["ar_err"]) == errs[r] > 0


@pytest.mark.parametrize("name", ["approx", "shard"])
def test_train_step_world_two(ranks, name):
    a, b = ranks
    assert np.isfinite(a[f"{name}_loss"]) and a[f"{name}_loss"] == b[
        f"{name}_loss"]
    np.testing.assert_array_equal(_u32(a[f"{name}_params"]),
                                  _u32(b[f"{name}_params"]))
    assert np.isfinite(a[f"{name}_params"]).all()
