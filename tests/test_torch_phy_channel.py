"""The layered PHY's channel stage on the CPU: the eager chain, no kernel.

``transport._through_channel`` takes the eager chain (``modulation.modulate``
-> ``channel.transmit`` -> ``channel.equalize``) for CPU tensors and the
channel-stage kernel (``kernels/phy_channel.py``) for CUDA ones. Here: the
CPU path is that chain bit for bit and launches nothing, and the kernel's
wrapper refuses every input it does not take before it builds or launches
anything. The kernel against the eager chain on the card is in
``tests/test_torch_cuda.py``.
"""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import modulation as TM  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.kernels import phy_channel as PK  # noqa: E402


def _bits(z):
    return torch.view_as_real(z).contiguous().view(torch.int32)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("mod", ["qpsk", "64qam"])
def test_through_channel_on_cpu_is_the_eager_chain(mod, fading, per_row,
                                                  monkeypatch):
    c, s = 3, 50
    snr = (float("inf"), 10.0, -3.0) if per_row else 7.0
    cfg = TT.TransportConfig(modulation=mod, channel=TCH.ChannelConfig(
        snr_db=snr, fading=fading, block_len=11))
    k = cfg.scheme.bits_per_symbol
    sym = P.randint(P.PRNGKey(s + k), (c, s), 0, 1 << k)
    keys = TT.client_keys(P.PRNGKey(5), c)
    snr_vec = TCH.snr_db_vector(snr, c) if per_row else None
    monkeypatch.setattr(PK.channel_stage, "launches", 0)
    TAC.reset_launch_counts()
    y, cc = TT._through_channel(sym, keys, cfg, snr_vec, gain=True)
    r, want_c = TCH.transmit(TM.modulate(sym, cfg.scheme), keys, cfg.channel,
                             snr_db=snr_vec)
    assert torch.equal(_bits(y), _bits(TCH.equalize(r, want_c)))
    assert torch.equal(_bits(cc), _bits(want_c))
    assert PK.channel_stage.launches == 0
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}


def _good():
    return dict(sym=torch.zeros((2, 5), dtype=torch.int64),
                keys=torch.zeros((2, 2), dtype=torch.int64), noise_power=0.1)


def _transposed(t):
    return t.t().contiguous().t()


_BAD = {
    "sym_dtype": (dict(sym=torch.zeros((2, 5), dtype=torch.int32)),
                  "sym must be"),
    "sym_shape": (dict(sym=torch.zeros((10,), dtype=torch.int64)),
                  "sym must be"),
    "sym_strided": (dict(sym=_transposed(torch.zeros((2, 5),
                                                     dtype=torch.int64))),
                    "sym must be"),
    "keys_dtype": (dict(keys=torch.zeros((2, 2), dtype=torch.int32)),
                   "keys must be"),
    "keys_shape": (dict(keys=torch.zeros((3, 2), dtype=torch.int64)),
                   "keys must be"),
    "keys_strided": (dict(keys=torch.zeros((2, 4), dtype=torch.int64)[:, ::2]),
                     "keys must be"),
    "noise_dtype": (dict(noise_power=torch.zeros((2,), dtype=torch.float64)),
                    "noise_power must be"),
    "noise_shape": (dict(noise_power=torch.zeros((3,))), "noise_power must be"),
    "bits": (dict(bits_per_symbol=3), "bits_per_symbol"),
    "fading": (dict(fading="rician"), "unknown fading"),
    "block_len": (dict(block_len=0), "block_len"),
    "row_length": (dict(sym=torch.empty((1, 2**32), dtype=torch.int64,
                                        device="meta"),
                        keys=torch.zeros((1, 2), dtype=torch.int64)),
                   "2\\*\\*32"),
    "device": ({}, "CUDA device"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_channel_stage_refuses_before_building(case, monkeypatch):
    def no_build(*args, **kw):
        raise AssertionError("built or loaded a kernel")

    monkeypatch.setattr(PK, "_library", no_build)
    monkeypatch.setattr(PK.build_lib, "load", no_build)
    override, match = _BAD[case]
    args = {**_good(), **override}
    kw = dict(bits_per_symbol=2, fading="rayleigh", block_len=64)
    kw.update({k: args.pop(k) for k in ("bits_per_symbol", "fading",
                                        "block_len") if k in args})
    before = PK.channel_stage.launches
    with pytest.raises(ValueError, match=match):
        PK.channel_stage(args["sym"], args["keys"], args["noise_power"], 1e-3,
                         **kw)
    assert PK.channel_stage.launches == before


def test_channel_stage_wrapper_imports_no_transport():
    """The arrow points one way, transport -> the channel-stage wrapper:
    ``kernels/phy_channel.py`` imports nothing of the transport module, at
    module level or inside a function."""
    tree = ast.parse(pathlib.Path(PK.__file__).read_text())
    found = [alias.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names]
    found += [f"{node.module}.{alias.name}" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module
              for alias in node.names]
    assert "repro_torch.kernels.build" in found
    assert not [m for m in found if "transport" in m], found


@pytest.mark.parametrize("mod", ["qpsk", "16qam"])
def test_through_channel_on_cpu_gives_c_only_when_asked(mod):
    """The CPU path honours ``gain`` as the kernel does: ``c`` is ``None``
    unless asked for, and ``y`` is the same either way."""
    cfg = TT.TransportConfig(modulation=mod,
                             channel=TCH.ChannelConfig(snr_db=7.0))
    k = cfg.scheme.bits_per_symbol
    sym = P.randint(P.PRNGKey(k), (2, 40), 0, 1 << k)
    keys = TT.client_keys(P.PRNGKey(6), 2)
    y, cc = TT._through_channel(sym, keys, cfg)
    y_gain, cc_gain = TT._through_channel(sym, keys, cfg, gain=True)
    assert cc is None and cc_gain is not None
    assert torch.equal(_bits(y), _bits(y_gain))


@pytest.mark.parametrize("bits", [
    torch.zeros(8, dtype=torch.int64),
    torch.zeros(8, dtype=torch.int32),
    torch.zeros((4, 4), dtype=torch.int32)[:, ::2],
], ids=["int64", "cpu", "strided"])
def test_normal_of_bits_refuses_before_building(bits, monkeypatch):
    def no_build(*args, **kw):
        raise AssertionError("built or loaded a kernel")

    monkeypatch.setattr(PK, "_library", no_build)
    with pytest.raises(ValueError, match="bits must be"):
        PK.normal_of_bits(bits)
