"""Package rules of the PyTorch/CUDA port.

* No module of ``src/repro_torch/``, not ``chip_smoke.py`` and not the
  card-only ``tests/test_torch_cuda.py`` imports ``jax`` or ``repro`` (an
  AST scan): all three run on a GPU machine without JAX.
* Entry points run on the GPU unless asked for the CPU: without a GPU
  they raise, with ``device="cpu"`` they run.
* Every engine argument of the reference is ported: ``scenario=``,
  ``compression=``, ``ledger=``, ``phase_timers=`` and ``sketches=`` run
  (a ledger that validates, the four timer scopes, sketches on
  ``iot-lowrate``; ``sketches=`` on a driverless run raises
  ``ValueError``, as in the reference); an unknown transport mode,
  dispatch, or ``fused_aggregate`` with the select dispatch raises
  ``ValueError``. The downlink, FedAvg and the ``iot-lowrate`` preset
  (which brings its own compression) run.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.mnist_cnn import config  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.fl.fedavg import run_fedavg  # noqa: E402
from repro_torch.fl.loop import run_fl  # noqa: E402
from repro_torch.link import policy as TP  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    tensor ops split over every core stall each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_port_covers_its_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES[:-2]}
    for mod in ("core/prng.py", "core/transport.py", "core/ecrt.py",
                "core/bounds.py", "core/latency.py", "kernels/ref.py",
                "kernels/approx_channel.py", "kernels/ops.py",
                "fl/engine.py", "fl/loop.py", "fl/fedavg.py", "convert.py",
                "link/dynamics.py", "link/estimator.py", "link/policy.py",
                "link/scenario.py", "compress/sparsify.py",
                "fl/async_engine.py", "configs/base.py",
                "configs/qwen2_1_5b.py", "models/layers.py",
                "models/attention.py", "models/transformer.py",
                "models/registry.py", "data/tokens.py", "launch/mesh.py",
                "launch/sharding.py", "launch/steps.py", "launch/train.py",
                "launch/serve.py", "launch/roofline.py",
                "checkpoint/io.py"):
        assert mod in names
    assert (ROOT / "src/repro_torch/kernels/csrc/approx_channel.cu").exists()


def _imported_modules(source):
    """Every module an ``import`` names, at any depth of the AST, with
    ``from a import b`` read as ``a.b``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out += [f"{node.module}.{alias.name}" for alias in node.names]
    return out


def test_kernel_wrappers_import_no_transport():
    """The arrows point one way, transport -> ops -> approx_channel ->
    ref: ``kernels/ops.py`` imports nothing of the transport module, at
    module level or inside a function."""
    planted = _imported_modules(
        "def f():\n    from repro_torch.core import transport as t\n")
    assert planted == ["repro_torch.core.transport"]
    found = _imported_modules(
        (ROOT / "src/repro_torch/kernels/ops.py").read_text())
    assert "repro_torch.kernels.approx_channel" in found
    assert not [m for m in found
                if m.startswith("repro_torch.core.transport")], found


def _world():
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (2, 8, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (2, 8)).astype(np.int32)
    return cx, cy, cx[0], cy[0]


def _approx():
    return TT.TransportConfig(mode="approx", use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=10.0))


def test_entry_points_need_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros((2, 1024))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_batch(x, P.PRNGKey(0), _approx())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_flat(x[0], P.PRNGKey(0), _approx())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_batch_aggregate(x, P.PRNGKey(0), _approx(),
                                    torch.full((2,), 0.5))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl(config(), _approx(), *_world(), n_rounds=1, batch_per_round=4)
    table = TP.build_mode_cfgs(_approx(), TP.PolicyConfig(),
                               ecrt_expected_tx=2.0, device="cpu")
    modes = np.asarray([1, 3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(0), table, modes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_batch_adaptive_aggregate(x, P.PRNGKey(0), table, modes,
                                             torch.full((2,), 0.5))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        # calibrates E[tx] for the ECRT row, on the GPU by default
        TP.build_mode_cfgs(_approx(), TP.PolicyConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl(config(), _approx(), *_world(), n_rounds=1, batch_per_round=4,
               scenario="vehicular")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fedavg(config(), _approx(), *_world(), n_rounds=1,
                   local_steps=1, batch_per_step=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl(config(), _approx(), *_world(), n_rounds=1, batch_per_round=4,
               downlink=TS.DownlinkConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_broadcast(x[0], P.PRNGKey(0), _approx(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.transmit_broadcast_adaptive(x[0], P.PRNGKey(0), table, modes)
    out, _ = TT.transmit_batch(x, P.PRNGKey(0), _approx(), device="cpu")
    assert out.device.type == "cpu"
    out, st = TT.transmit_batch_adaptive(x, P.PRNGKey(0), table, modes,
                                         device="cpu")
    assert out.device.type == "cpu" and st.mode_idx.tolist() == [1, 3]
    res = run_fl(config(), _approx(), *_world(), n_rounds=1,
                 batch_per_round=4, device="cpu")
    assert np.isfinite(res.final_accuracy)
    res = run_fl(config(), _approx(), *_world(), n_rounds=1,
                 batch_per_round=4, scenario="vehicular", device="cpu")
    assert np.isfinite(res.final_accuracy) and len(res.link) == 1
    out, _ = TT.transmit_broadcast(x[0], P.PRNGKey(0), _approx(), 2,
                                   device="cpu")
    assert out.device.type == "cpu" and out.shape == (2, 1024)
    res = run_fedavg(config(), _approx(), *_world(), n_rounds=1,
                     local_steps=1, batch_per_step=4,
                     downlink=TS.DownlinkConfig(), device="cpu")
    assert np.isfinite(res.final_accuracy) and len(res.link) == 1


def test_llm_entry_points_need_a_gpu_unless_asked(monkeypatch, capsys):
    """The trainer and the server run on the GPU by default; ``--device
    cpu`` runs them on the CPU."""
    from repro_torch.launch import serve, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--arch", "yi-6b", "--reduced"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(small + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(small + ["--gen", "1"])
    _, gen, _ = serve.main(small + ["--batch", "1", "--prompt-len", "2",
                                 "--gen", "2", "--device", "cpu"])
    assert gen.shape == (1, 2)
    assert "yi-6b" in capsys.readouterr().out


def test_buffered_entry_points_need_a_gpu_unless_asked(monkeypatch):
    """``run_fl_buffered``, ``run_fedavg_buffered`` and
    ``AsyncRoundEngine`` default to the GPU like the sync entry points."""
    from repro_torch.fl import (AsyncRoundEngine, FedSGD,
                                run_fedavg_buffered, run_fl_buffered)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(n_rounds=1, batch_per_round=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl_buffered(config(), _approx(), *_world(), **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fedavg_buffered(config(), _approx(), *_world(), n_rounds=1,
                            local_steps=1, batch_per_step=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncRoundEngine(FedSGD(config(), batch_per_round=4), _approx(),
                         *_world(), n_rounds=1)
    res = run_fl_buffered(config(), _approx(), *_world(), device="cpu",
                          scenario="metro-rush", buffer_k=1, **kw)
    assert np.isfinite(res.final_accuracy) and len(res.event_s) == 1


def test_kernel_wrappers_reject_other_devices():
    from repro_torch.kernels import approx_channel as ac

    x = torch.zeros((2, 1024), device="meta")
    s = torch.zeros((2,), dtype=torch.int64, device="meta")
    f = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ac.approx_channel_batch_kernel(x, s, f, f)


@pytest.mark.parametrize("mode,kernel", [
    ("approx", False),
    ("naive", False),
    ("ecrt", False),
    ("ecrt", True),
])
def test_layered_and_ecrt_modes_run(mode, kernel):
    """The four calls that raised before the layered PHY and ECRT were
    ported: each runs and returns finite stats shaped as the reference's
    (``(C,)`` fields for a batch, scalars for one client). ECRT ignores
    ``use_kernel``, as in the reference."""
    cfg = TT.TransportConfig(mode=mode, use_kernel=kernel,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    x = torch.linspace(-0.5, 0.5, 128).reshape(2, 64)
    fields = ("data_symbols", "transmissions", "bit_errors", "n_bits",
              "bits_on_air")
    for call, out_shape, stat_shape in (
            (lambda: TT.transmit_batch(x, P.PRNGKey(0), cfg, device="cpu"),
             (2, 64), (2,)),
            (lambda: TT.transmit_flat(x[0], P.PRNGKey(0), cfg, device="cpu"),
             (64,), ()),
            (lambda: TT.transmit_batch_aggregate(
                x, P.PRNGKey(0), cfg, torch.full((2,), 0.5), device="cpu"),
             (64,), (2,))):
        out, st = call()
        assert out.shape == out_shape and out.dtype == torch.float32
        for f in fields:
            v = getattr(st, f)
            assert v.shape == stat_shape and bool(torch.isfinite(v).all())
        assert bool((st.transmissions >= 1).all())
        if mode == "ecrt":  # exact bits at the PS
            assert not st.bit_errors.any()
    res = run_fl(config(), cfg, *_world(), n_rounds=1, batch_per_round=4,
                 device="cpu")
    assert np.isfinite(res.final_accuracy) and res.airtime_s[0] > 0


def test_unknown_mode_raises():
    cfg = TT.TransportConfig(mode="telepathy")
    x = torch.zeros((2, 64))
    for call in (lambda: TT.transmit_batch(x, P.PRNGKey(0), cfg, device="cpu"),
                 lambda: TT.transmit_flat(x[0], P.PRNGKey(0), cfg,
                                          device="cpu"),
                 lambda: run_fl(config(), cfg, *_world(), n_rounds=1,
                                device="cpu")):
        with pytest.raises(ValueError, match="telepathy"):
            call()


@pytest.mark.parametrize("arg", ["scenario", "compression", "ledger",
                                 "phase_timers", "sketches"])
def test_unported_engine_arguments_raise(arg, tmp_path):
    """Each engine argument that raised until its item was ported now runs,
    under ``run_fl`` and ``run_fedavg``: a scenario that brings compression
    and an explicit ``CompressionConfig`` report the compression fields; a
    ledger validates and reads back to ``FLResult.link``; phase timers hold
    the four scopes; sketches on a driverless run raise ``ValueError`` (as
    in the reference) and on ``iot-lowrate`` fill each round's group."""
    from repro_torch.obs import PhaseTimers
    from repro_torch.obs import ledger as TL

    for run in (run_fl, run_fedavg):
        if arg in ("scenario", "compression"):
            value = ("iot-lowrate" if arg == "scenario"
                     else TS.CompressionConfig())
            res = run(config(), _approx(), *_world(), n_rounds=1,
                      device="cpu", **{arg: value})
            assert res.link[0]["comp_bits_on_air"] > 0
        elif arg == "ledger":
            path = str(tmp_path / f"{run.__name__}.jsonl")
            res = run(config(), _approx(), *_world(), n_rounds=1,
                      device="cpu", scenario="vehicular", ledger=path)
            assert TL.validate_ledger(path) == []
            assert TL.read_ledger(path).link == res.link
        elif arg == "phase_timers":
            timers = PhaseTimers()
            run(config(), _approx(), *_world(), n_rounds=1, device="cpu",
                phase_timers=timers)
            assert set(timers.summary()) == {"sample", "round", "telemetry",
                                             "eval"}
        else:
            with pytest.raises(ValueError, match="needs a scenario"):
                run(config(), _approx(), *_world(), n_rounds=1,
                    device="cpu", sketches=True)
            res = run(config(), _approx(), *_world(), n_rounds=1,
                      device="cpu", scenario="iot-lowrate", sketches=True)
            group = res.records[0].sketches
            assert group["snr_db"]["total"] == 2
            assert group["ber"]["total"] == res.link[0]["n_active"]


@pytest.mark.parametrize("name,item", [("iot-lowrate", "item 6")])
def test_scenarios_with_unported_legs_raise(name, item):
    """The preset that raised until its leg (``item``) was ported now runs,
    its per-mode slot budgets under the bucketed dispatch; under select its
    ``compress_ratios`` raise ``ValueError``, as in the reference."""
    res = run_fl(config(), _approx(), *_world(), n_rounds=1,
                 batch_per_round=4, device="cpu", scenario=name)
    assert list(res.link[0])[7:] == ["comp_ratio", "comp_bits_on_air",
                                     "comp_residual_norm"]
    with pytest.raises(ValueError, match="bucketed"):
        run_fl(config(), _approx(), *_world(), n_rounds=1, device="cpu",
               scenario=name, adaptive_dispatch="select")


@pytest.mark.parametrize("name", ["static-noisy-dl", "vehicular-noisy-dl"])
def test_downlink_scenarios_run(name):
    """The two presets that bring a downlink, which raised before the
    downlink was ported, run a round and report its downlink fields."""
    res = run_fl(config(), _approx(), *_world(), n_rounds=1,
                 batch_per_round=4, device="cpu", scenario=name)
    tail = ["downlink_airtime_s", "downlink_ber"] + (
        ["downlink_mode_counts"] if name == "vehicular-noisy-dl" else [])
    assert list(res.link[0])[7:] == tail
    assert res.link[0]["downlink_airtime_s"] > 0
    assert set(res.phase_s[0]) >= {"downlink", "downlink_keys",
                                   "downlink_kernel"}


def test_downlink_and_fedavg_argument_checks():
    """The reference's ``ValueError``s: an adaptive downlink without a
    scenario, ``max_abs`` with the fused round, a non-flat broadcast."""
    with pytest.raises(ValueError, match="needs a scenario"):
        run_fl(config(), _approx(), *_world(), n_rounds=1, device="cpu",
               downlink=TS.DownlinkConfig(adaptive=True))
    with pytest.raises(ValueError, match="max_abs"):
        run_fedavg(config(), _approx(), *_world(), n_rounds=1,
                   scale_mode="max_abs", fused_aggregate=True, device="cpu")
    with pytest.raises(ValueError, match="flat"):
        TT.transmit_broadcast(torch.zeros((2, 8)), P.PRNGKey(0), _approx(),
                              2, device="cpu")


def test_perfect_mode_runs_without_kernels():
    res = run_fl(config(), TT.TransportConfig(mode="perfect"), *_world(),
                 n_rounds=2, batch_per_round=4, eval_every=1, device="cpu")
    assert res.rounds == [0, 1] and res.link == []
    # adaptive_dispatch is checked as the reference checks it, and
    # fused_aggregate needs the bucketed dispatch on scenario runs.
    with pytest.raises(ValueError, match="adaptive_dispatch"):
        TE.RoundEngine(TE.FedSGD(config()), TT.TransportConfig(mode="perfect"),
                       *_world(), n_rounds=1, adaptive_dispatch="sideways",
                       device="cpu")
    with pytest.raises(ValueError, match="bucketed"):
        run_fl(config(), _approx(), *_world(), n_rounds=1, device="cpu",
               scenario="static", adaptive_dispatch="select",
               fused_aggregate=True)


def test_uplink_parts_lie_within_the_uplink():
    res = run_fl(config(), _approx(), *_world(), n_rounds=2,
                 batch_per_round=4, eval_every=1, device="cpu")
    for ph in res.phase_s:
        assert ph["uplink_keys"] > 0 and ph["uplink_kernel"] > 0
        assert ph["uplink_keys"] + ph["uplink_kernel"] <= ph["uplink"]
    res = run_fl(config(), _approx(), *_world(), n_rounds=2,
                 batch_per_round=4, eval_every=1, device="cpu",
                 downlink=TS.DownlinkConfig())
    for ph in res.phase_s:
        assert ph["downlink_keys"] > 0 and ph["downlink_kernel"] > 0
        assert ph["downlink_keys"] + ph["downlink_kernel"] <= ph["downlink"]
        assert ph["uplink_keys"] > 0 and ph["uplink_kernel"] > 0


def test_spans_time_only_inside_a_collecting_scope():
    from repro_torch.obs import spans

    with spans.span("keys"):
        pass  # no scope: nothing recorded, nothing raised
    with spans.collect("cpu") as seconds:
        for _ in range(2):
            with spans.span("keys"):
                pass
        with spans.span("kernel"):
            pass
    assert set(seconds) == {"keys", "kernel"}
    assert all(v >= 0 for v in seconds.values())
    with spans.span("keys"):
        pass
    assert set(seconds) == {"keys", "kernel"}


_FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: writes the -o target, prints ptxas-like lines.
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "fake library" > "$out"
echo "ptxas info    : Compiling entry function 'k1_approx_channel_batch'" >&2
echo "ptxas info    : Used 32 registers" >&2
"""


def test_reused_build_reports_its_compiler_output(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    toolkit = tmp_path / "cuda"
    (toolkit / "bin").mkdir(parents=True)
    nvcc = toolkit / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(toolkit))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    lib, log, seconds = build.build.__wrapped__("approx_channel")
    assert lib.exists() and seconds > 0
    assert "Compiling entry function" in log
    again = build.build.__wrapped__("approx_channel")
    assert again == (lib, log, 0.0)
    # A library without its log (an older build) is compiled again.
    lib.with_suffix(".log").unlink()
    _, log3, seconds3 = build.build.__wrapped__("approx_channel")
    assert log3 == log and seconds3 > 0
