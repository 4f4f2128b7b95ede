"""The port's launch layer against the reference's (``launch/``,
``core/aggregation.py``, ``checkpoint/io.py``, the trainer's uplink).

* **Exact**: ``param_rules`` / ``checked_spec`` on every leaf of every
  dense and moe architecture at its published widths, ``batch_specs`` and
  ``cache_specs``, against the reference's ``PartitionSpec`` entries on
  fake meshes (the reference test's ``(2, 16, 16)`` pod layout,
  ``(1, 1)``, ``(2, 1)`` and ``(4, 2)``); checkpoints written by one
  package restored by the other (float32 and bf16 trees, manifest keys
  equal); ``transmit_pytree`` of fixed gradient trees under
  ``use_kernel=True`` (the reference's Pallas kernel in interpret mode,
  outside ``shard_map``; the port's plain K1) — received bits and
  ``TxStats``, a tree a whole number of tiles long and one not;
  ``corrupt_per_shard`` at a world of one against the reference's
  ``transmit_pytree`` under ``fold_in(key, 0)`` on the layered PHY; the
  ``ValueError`` of a row over 2**31 - 1 words; ``uplink_traffic``'s
  byte counts; ``serve.main``'s prompt and greedy tokens against the
  reference's serve step, full and ring caches.

The training trajectories are in ``test_torch_train.py``. Sizes: 2
layers, d_model 64, d_ff 128, vocab 128, as the reference tests.
"""

import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import io as JCK  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.launch import roofline as JRF  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as TCK  # noqa: E402
from repro_torch.core import aggregation as TAG  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline as TRF  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128)
PORTED = [a for a in JC.ARCH_IDS
          if JC.get_config(a).family in ("dense", "moe")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    tensor ops split over every core stall each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _fake(axis_names, sizes):
    class FakeMesh:
        pass

    m = FakeMesh()
    m.axis_names = tuple(axis_names)
    m.shape = dict(zip(axis_names, sizes))
    return m


MESHES = {
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "1x1": (("data", "model"), (1, 1)),
    "2x1": (("data", "model"), (2, 1)),
    "4x2": (("data", "model"), (4, 2)),
}


def _path(keypath) -> str:
    return "/".join(str(k.key) for k in keypath)


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_rules_exact(arch, mesh_name):
    mesh = _fake(*MESHES[mesh_name])
    cj, ct = JC.get_config(arch), TC.get_config(arch)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree = {}
    for keypath, leaf in leaves:
        node = tree
        for k in keypath[:-1]:
            node = node.setdefault(k.key, {})
        node[keypath[-1].key] = leaf
    specs = TSH.tree_specs(tree, ct, mesh, fsdp=True)
    for fsdp in (True, False):
        for keypath, leaf in leaves:
            want = tuple(JSH.param_rules(jax.tree_util.keystr(keypath),
                                         leaf.shape, cj, mesh, fsdp=fsdp))
            got = TSH.param_rules(_path(keypath), leaf.shape, ct, mesh,
                                  fsdp=fsdp)
            assert got == want, (arch, _path(keypath), fsdp)
            if fsdp:
                node = specs
                for k in keypath:
                    node = node[k.key]
                assert node == want
    for shape in [(4096, 11008), (7, 5), (32, 1)]:
        axes = (("data",), "model")
        assert TSH.checked_spec(shape, axes, mesh) == tuple(
            JSH.checked_spec(shape, axes, mesh))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_exact(arch, mesh_name, monkeypatch):
    """The reference wraps each cache spec in a ``NamedSharding``, which
    needs a real mesh; the fake mesh keeps the bare spec."""
    from jax.sharding import PartitionSpec

    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    mesh = _fake(*MESHES[mesh_name])
    cj, ct = JC.get_config(arch), TC.get_config(arch)
    for name in JC.INPUT_SHAPES:
        sj, st = JC.INPUT_SHAPES[name], TC.INPUT_SHAPES[name]
        want = {k: tuple(v) for k, v in JSH.batch_specs(cj, sj, mesh).items()}
        assert TSH.batch_specs(ct, st, mesh) == want
        if sj.kind != "decode":
            continue
        clen = JR.cache_len_for(cj, sj)
        cache_j = jax.eval_shape(lambda: JR.init_cache(cj, sj.global_batch,
                                                       clen))
        specs_j = jax.tree_util.tree_map(
            tuple, JSH.cache_specs(cj, sj, mesh, cache_j),
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        cache_t = TR.init_cache(ct, st.global_batch, clen, device="meta")
        assert TSH.cache_specs(ct, st, mesh, cache_t) == specs_j
    assert TSH.normalize_path("['layers']['attn']['wq']") == \
        JSH.normalize_path("['layers']['attn']['wq']") == "layers/attn/wq"


def test_world_mesh_of_one():
    m = TM.world_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.group is None
    assert TM.data_axes(m) == ("data",)
    assert TM.data_axes(_fake(*MESHES["pod2x16x16"])) == ("pod", "data")
    with pytest.raises(ValueError, match="model axis"):
        TM.world_mesh((1, 2))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TM.world_mesh((2, 1))


# ------------------------------------------------------------ checkpoints


def _trees(dtype):
    rng = np.random.default_rng(3)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = {"embed": jnp.asarray(rng.standard_normal((5, 4)), jd),
         "layers": {"attn": {"wq": jnp.asarray(rng.standard_normal((2, 4, 4)),
                                               jd)},
                    "ln1": jnp.asarray(rng.standard_normal((2, 4)), jd)},
         "final_norm": jnp.asarray(rng.standard_normal((4,)), jd)}
    return j, convert.params_from_jax(jax.tree_util.tree_map(np.asarray, j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_port_to_reference_exact(tmp_path, dtype):
    j, t = _trees(dtype)
    TCK.save(str(tmp_path), t, step=7, extra={"arch": "x"})
    back, step = JCK.restore(str(tmp_path), j)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    mine, step = TCK.restore(str(tmp_path), t)
    for a, b in zip(TT.tree_flatten(mine)[0], TT.tree_flatten(t)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_reference_to_port_exact(tmp_path, dtype):
    j, t = _trees(dtype)
    JCK.save(str(tmp_path), j, step=3)
    import json
    keys = json.load(open(tmp_path / "manifest.json"))["keys"]
    assert keys == TCK.tree_keys(t)
    back, step = TCK.restore(str(tmp_path), t)
    assert step == 3
    for a, b in zip(TT.tree_flatten(back)[0], TT.tree_flatten(t)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="structure"):
        TCK.restore(str(tmp_path), {"other": t["embed"]})


# ----------------------------------------------------- the trainer's uplink


def _grad_tree(total_rest):
    rng = np.random.default_rng(total_rest)
    return {"b": rng.uniform(-0.5, 0.5, (3, 256)).astype(np.float32),
            "a": {"w": rng.uniform(-0.01, 0.01, (16, 64)).astype(np.float32),
                  "v": rng.uniform(-2, 2, (total_rest,)).astype(np.float32)}}


def _stats_equal(sj, st):
    for f in ("data_symbols", "transmissions", "bit_errors", "n_bits",
              "bits_on_air"):
        a, b = getattr(sj, f), getattr(st, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.cpu().numpy(), err_msg=f)


@pytest.mark.parametrize("rest,mode", [(1280, "approx"), (676, "approx"),
                                       (676, "naive")])
def test_transmit_pytree_kernel_path_exact(rest, mode):
    """3,072 floats (three whole tiles) and 2,468 (padded): the reference's
    K0 in interpret mode against the port's plain K1, the received bits
    and the stats equal."""
    tree = _grad_tree(rest)
    kw = dict(mode=mode, use_kernel=True)
    cj = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=10.0), **kw)
    ct = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=10.0), **kw)
    key = 11
    hj, sj = JT.transmit_pytree(jax.tree_util.tree_map(jnp.asarray, tree),
                                jax.random.PRNGKey(key), cj)
    ht, st = TT.transmit_pytree(convert.params_from_jax(tree), P.PRNGKey(key),
                                ct, device="cpu")
    lj, lt = jax.tree_util.tree_leaves(hj), TT.tree_flatten(ht)[0]
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32))
    _stats_equal(sj, st)
    assert float(st.bit_errors) > 0


def test_corrupt_per_shard_world_of_one_exact():
    """World of one: the whole tree is one shard under ``fold_in(key, 0)``,
    the reference's ``transmit_pytree`` on the layered PHY bit for bit."""
    tree = _grad_tree(676)
    cj = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=10.0))
    ct = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=10.0))
    hj, _ = JT.transmit_pytree(jax.tree_util.tree_map(jnp.asarray, tree),
                               jax.random.fold_in(jax.random.PRNGKey(4), 0), cj)
    ht = TST.corrupt_per_shard(convert.params_from_jax(tree), P.PRNGKey(4), ct,
                               None)
    for a, b in zip(jax.tree_util.tree_leaves(hj), TT.tree_flatten(ht)[0]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32))


def test_approx_allreduce_world_of_one():
    """Group ``None``: ``fold_in(key, 0)``'s uplink, float32, no copy; a
    perfect uplink leaves the gradient bit for bit."""
    tree = convert.params_from_jax(_grad_tree(676))
    ct = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=10.0))
    got, st = TAG.approx_allreduce(tree, P.PRNGKey(9), ct)
    want, sw = TT.transmit_pytree(tree, P.fold_in(P.PRNGKey(9), 0), ct,
                                  device="cpu")
    for a, b in zip(TT.tree_flatten(got)[0], TT.tree_flatten(want)[0]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert float(st.bit_errors) == float(sw.bit_errors) > 0
    same, _ = TAG.approx_allreduce(tree, P.PRNGKey(9),
                                   dataclasses.replace(ct, mode="perfect"))
    for a, b in zip(TT.tree_flatten(same)[0], TT.tree_flatten(tree)[0]):
        assert torch.equal(a, b)


def test_row_over_int32_raises():
    """K1 and K2 refuse a row past 2**31 - 1 words (after padding) before
    any work, on every device, naming themselves; K0's row length is
    64-bit, so on such a row it gets past the row check and stops at the
    device check (meta tensors hold no data)."""
    x = torch.empty(2**31 - 1000, device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors, got meta"):
        TO.approx_channel(x, torch.tensor(1), torch.tensor(0.1), 1.0)
    with pytest.raises(ValueError, match="needs CUDA tensors, got meta"):
        TAC.approx_channel_kernel(torch.empty(3_549_796_352, device="meta"),
                                  1, 0.1, 1.0)
    with pytest.raises(ValueError, match="K1: .*2\\*\\*31 - 1"):
        TAC.approx_channel_batch_kernel(
            torch.empty((1, 2**31), device="meta"),
            torch.ones(1, dtype=torch.int32), torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="K2: .*2\\*\\*31 - 1"):
        TAC.approx_channel_batch_aggregate_kernel(
            torch.empty((1, 2**31), device="meta"),
            torch.ones(1, dtype=torch.int32), torch.ones(1), torch.ones(1),
            torch.ones(1))
    assert TAC.MAX_ROW_WORDS == 2**31 - 1
    # qwen2-1.5b's row fits K1's limit; recurrentgemma-2b's at its
    # published 26 layers (3,549,795,840 words) is past it
    assert math.ceil(1_777_088_000 / 1024) * 1024 <= TAC.MAX_ROW_WORDS
    assert math.ceil(3_549_795_840 / 1024) * 1024 > TAC.MAX_ROW_WORDS


def test_plain_tiles_at_an_offset_and_the_counter_wrap():
    """The plain K0 of a row too long to hold runs tile range by tile range
    (``first_tile``): the ranges give the whole row's words and errors. The
    symbol counter is uint32, as the reference's: tile 262,144 of a float32
    QPSK row (16 symbols a word) starts at symbol 2**32 = 0, so it draws
    tile 0's fading and noise."""
    from repro_torch.kernels import ref as TRF_

    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.9, 0.9, 5 * 1024).astype(np.float32))
    kw = dict(seed=torch.tensor(77), noise_power=torch.tensor(0.05),
              large_scale_gain=torch.tensor(1.0))
    whole, errs = TRF_.ref_approx_channel(x, **kw)
    total = 0
    for t0, t1 in ((0, 2), (2, 3), (3, 5)):
        part, e = TRF_.ref_approx_channel(x[t0 * 1024:t1 * 1024],
                                          first_tile=t0, **kw)
        assert torch.equal(part.view(torch.int32),
                           whole[t0 * 1024:t1 * 1024].view(torch.int32))
        total += int(e)
    assert total == int(errs) > 0
    wrapped, e = TRF_.ref_approx_channel(x[:1024], first_tile=262_144, **kw)
    first, e0 = TRF_.ref_approx_channel(x[:1024], **kw)
    assert torch.equal(wrapped.view(torch.int32), first.view(torch.int32))
    assert int(e) == int(e0)
    other, _ = TRF_.ref_approx_channel(x[:1024], first_tile=262_143, **kw)
    assert not torch.equal(other.view(torch.int32), first.view(torch.int32))


@pytest.mark.parametrize("clients,k,wire", [(1, 2, "float32"), (100, 4,
                                                                "bfloat16")])
def test_uplink_traffic(clients, k, wire):
    a = JRF.uplink_traffic(clients, bits_per_symbol=k, wire_dtype=wire,
                           n_floats=21840)
    b = TRF.uplink_traffic(clients, bits_per_symbol=k, wire_dtype=wire,
                           n_floats=21840)
    assert a["bytes_per_float"] == b["bytes_per_float"]
    assert a["ratio_vs_fused"] == b["ratio_vs_fused"]
    for name, v in b["bytes_per_float"].items():
        assert b["hbm_s"][name] == clients * 21840 * v / 3.35e12
    tc = TT.TransportConfig(modulation="16qam", wire_dtype=wire)
    assert TRF.transport_traffic(tc, clients)["bits_per_symbol"] == 4


@pytest.mark.parametrize("ring", [False, True])
def test_serve_main_greedy_tokens(ring):
    """``serve.main`` at reduced width: the prompt is the reference's draw
    and the greedy tokens equal the reference's serve step's, token for
    token; the printed sample line too."""
    args = ["--batch", "2", "--prompt-len", "8", "--gen", "6"] + (
        ["--ring"] if ring else [])
    out_t = io.StringIO()
    with contextlib.redirect_stdout(out_t):
        prompt, gen, _ = TSV.main(args + ["--reduced", "--device", "cpu"])
    out_j = io.StringIO()
    with contextlib.redirect_stdout(out_j):
        JSV.main(args)
    sample = lambda s: s.strip().splitlines()[-1]  # noqa: E731
    assert sample(out_t.getvalue()) == sample(out_j.getvalue())
    cfg = JC.get_config("qwen2-1.5b").reduced()
    key = jax.random.PRNGKey(0)
    params = JR.init_params(key, cfg)
    want_prompt = jax.random.randint(key, (2, 8), 0, cfg.vocab_size, jnp.int32)
    np.testing.assert_array_equal(prompt.numpy(), np.asarray(want_prompt))
    cache = JR.init_cache(cfg, 2, cfg.decode_window if ring else 14)
    step = jax.jit(JST.make_serve_step(cfg, ring=ring))
    tok, outs = want_prompt[:, :1], []
    for pos in range(13):
        nxt, cache = step(params, cache, tok, jnp.int32(pos))
        tok = want_prompt[:, pos + 1:pos + 2] if pos + 1 < 8 else nxt
        if pos + 1 >= 8:
            outs.append(np.asarray(nxt))
    np.testing.assert_array_equal(gen.numpy(), np.concatenate(outs, 1))


def test_prefill_step_is_last_logits():
    _, ct = JC.get_config("qwen2-1.5b"), TC.get_config("qwen2-1.5b").reduced(
        **SMALL)
    params = TR.init_params(P.PRNGKey(1), ct)
    tokens = torch.randint(0, 128, (2, 8), generator=torch.Generator()
                           .manual_seed(0))
    last = TST.make_prefill_step(ct)(params, {"tokens": tokens})
    with torch.no_grad():
        full, _ = TR.forward(params, {"tokens": tokens}, ct)
    assert torch.equal(last, full[:, -1])
