"""The port's ``launch/dryrun.py`` and ``launch/roofline.py``'s counts
against the reference's.

* ``n_active_params`` (active and total) and ``model_flops`` of every
  shape: **Exact** against ``repro.launch.roofline`` for all ten archs at
  full depth. The port builds the tree on the meta device; the reference
  takes it from ``jax.eval_shape``. The leaf paths, spelled as ``keystr``,
  and shapes are Exact against ``tree_flatten_with_path`` of the
  reference's tree, so the float64 sums run in one order.
* ``extrapolate`` and ``_body_counts``: Exact on records made from a seed.
* ``default_uplink``: Exact for every arch and shape (the reference's
  module sets ``XLA_FLAGS`` when it is imported, so it is asked in a
  subprocess).
* ``run_one`` on the meta device: ``ok`` for each family and each shape
  kind (train, prefill, decode, and ``long_500k``'s ring caches), at two
  layers; whisper's ``long_500k`` is the ``supports_shape`` skip. The
  record's keys, FLOPs that scale with a rank's rows (but for a moe
  layer's capacity, which is a rank's and at least 8), argument bytes
  that hold the params. ``main`` writes its records.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import roofline as JRF  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import roofline as TRF  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_counts_exact(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert TRF.n_active_params(tcfg) == JRF.n_active_params(jcfg)
    for name in JC.INPUT_SHAPES:
        assert (TRF.model_flops(tcfg, TC.INPUT_SHAPES[name])
                == JRF.model_flops(jcfg, JC.INPUT_SHAPES[name]))
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = [(jax.tree_util.keystr(p), tuple(l.shape)) for p, l in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(p, tuple(l.shape)) for p, l in TRF._leaves_with_keystr(
        TR.init_params(P.PRNGKey(0, device="meta"), tcfg))]
    assert got == want


def _record(rng, layers):
    kinds = list(TRF._COLL_KINDS) + ["_total"]
    return {"reduced_layers": layers,
            "flops_per_device": float(rng.uniform(1e12, 1e14)),
            "bytes_per_device": float(rng.uniform(1e9, 1e11)),
            "collective_bytes_per_device": {
                k: float(rng.uniform(-1e9, 1e9)) for k in kinds[::2]}}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "kimi-k2-1t-a32b",
                                  "whisper-large-v3"])
def test_extrapolate_exact(arch):
    rng = np.random.default_rng(7)
    for k1, k2 in ((2, 4), (1, 3), (3, 8)):
        r1, r2 = _record(rng, k1), _record(rng, k2)
        jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        if TRF._body_counts(tcfg, k1) == TRF._body_counts(tcfg, k2):
            continue
        assert TRF.extrapolate(tcfg, r1, r2, tcfg.n_layers) == \
            JRF.extrapolate(jcfg, r1, r2, jcfg.n_layers)
        for k in (k1, k2, tcfg.n_layers):
            assert TRF._body_counts(tcfg, k) == JRF._body_counts(jcfg, k)


def test_default_uplink_exact():
    code = ("import json; from repro.configs import ARCH_IDS, INPUT_SHAPES;"
            " from repro.launch import dryrun as D;"
            " print(json.dumps({f'{a}|{s}': D.default_uplink(a, s)"
            " for a in ARCH_IDS for s in INPUT_SHAPES}))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {f"{a}|{s}": TD.default_uplink(a, s) for a in TC.ARCH_IDS
           for s in TC.INPUT_SHAPES}
    assert got == want


FAMILIES = {"dense": "qwen2-1.5b", "moe": "phi3.5-moe-42b-a6.6b",
            "vlm": "pixtral-12b", "hybrid": "recurrentgemma-2b",
            "ssm": "falcon-mamba-7b", "audio": "whisper-large-v3"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_one_on_meta(family):
    arch = FAMILIES[family]
    for shape in TC.INPUT_SHAPES:
        recs = {w: TD.run_one(arch, shape, w, reduced_layers=2)
                for w in (1, 8)}
        cfg = TC.get_config(arch)
        ok, reason = TR.supports_shape(cfg, TC.INPUT_SHAPES[shape])
        if not ok:
            assert recs[1]["status"] == "skip" and recs[1]["reason"] == reason
            continue
        r = recs[1]
        assert r["status"] == "ok", r
        for key in ("arch", "shape", "world", "uplink", "reduced_layers",
                    "reason", "overrides", "wire_dtype", "flops_per_device",
                    "memory", "model_flops"):
            assert key in r
        assert set(r["memory"]) == {"argument_bytes", "output_bytes"}
        assert "n_chips" not in r and "compile_s" not in r
        small = TD._reduce_depth(cfg, 2)
        n_params = TRF.n_active_params(small)[1]
        assert r["memory"]["argument_bytes"] >= 2 * n_params
        assert r["model_flops"] == TRF.model_flops(small,
                                                   TC.INPUT_SHAPES[shape])
        assert r["flops_per_device"] > 0
        if TC.INPUT_SHAPES[shape].global_batch % 8 == 0:
            if family == "moe":  # the expert capacity is a rank's, >= 8
                assert recs[8]["flops_per_device"] < r["flops_per_device"]
            else:
                assert recs[8]["flops_per_device"] == pytest.approx(
                    r["flops_per_device"] / 8, rel=1e-12)
        if TC.INPUT_SHAPES[shape].kind == "train":
            assert r["uplink"] == TD.default_uplink(arch, shape)
            assert r["uplink_traffic"]["bytes_per_float"]


def test_main_writes_records(tmp_path):
    TD.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--world",
             "1,2", "--out", str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    assert names == ["qwen2-1.5b__decode_32k__w1__none.json",
                     "qwen2-1.5b__decode_32k__w2__none.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["status"] == "ok" and rec["world"] == 1
    n = TRF.n_active_params(TC.get_config("qwen2-1.5b"))[1]
    # full depth: bf16 params among the arguments
    assert rec["memory"]["argument_bytes"] >= 2 * n
    over = TD.run_one("phi3.5-moe-42b-a6.6b", "prefill_32k", 2,
                      reduced_layers=1,
                      overrides={"moe_impl": "expert_parallel"})
    dense = TD.run_one("phi3.5-moe-42b-a6.6b", "prefill_32k", 2,
                       reduced_layers=1)
    assert over["overrides"] == {"moe_impl": "expert_parallel"}
    assert over["flops_per_device"] == dense["flops_per_device"]
