"""Wrapper of the CUDA kernel of the layered PHY's channel stage.

:func:`channel_stage` computes in one launch of
``csrc/phy_channel.cu::phy_channel_stage`` what
``core/transport.py::_through_channel`` computes on the CPU as tensor
operations: Gray QAM (``modulation.modulate``), fading and noise drawn
with threefry normals (``channel.transmit``) and zero-forcing
(``channel.equalize``), bit for bit the eager chain run on the card. That
eager chain is the kernel's plain version; the transport takes it for CPU
tensors and this wrapper for CUDA ones. It replaces no TPU kernel (the JAX
package's layered channel is plain ``jnp``).

The wrapper takes plain tensors and numbers, checks them before it builds
or launches anything, computes the per-row scales with the torch
expressions ``channel.transmit`` and ``channel._cn`` use, allocates the
outputs and launches on the current stream. It adds one to
``channel_stage.launches`` each time it launches; that counter is not one
of :func:`repro_torch.kernels.approx_channel.launch_counts`'s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import approx_channel as ac
from repro_torch.kernels import build as build_lib

__all__ = ["channel_stage", "normal_of_bits"]

_SOURCE = "phy_channel"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# ctypes signature of csrc/phy_channel.cu's extern "C" entry; it returns
# cudaGetLastError() as an int.
SIGNATURE = [
    _P, _P, _P, _P, _P, _I,  # sym, keys, y, c, nscale, nscale_step
    _L, _L, _I, _I, _L,      # rows, n, k, fading, block_len
    _F, _F, _F, _P,          # hscale, gain_amp, point_amp, stream
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_lib.load(_SOURCE)
    lib.repro_phy_channel_stage.argtypes = SIGNATURE
    lib.repro_phy_channel_stage.restype = _I
    lib.repro_phy_normal_of_bits.argtypes = [_P, _P, _L, _P]
    lib.repro_phy_normal_of_bits.restype = _I
    return lib


def _check(sym, keys, noise_power, bits_per_symbol, fading, block_len):
    if sym.dtype != torch.int64 or sym.ndim != 2 or not sym.is_contiguous():
        raise ValueError("sym must be a contiguous (C, S) int64 tensor, got "
                         f"{sym.dtype} {tuple(sym.shape)}")
    c, s = sym.shape
    if (keys.dtype != torch.int64 or keys.shape != (c, 2)
            or not keys.is_contiguous()):
        raise ValueError(f"keys must be a contiguous ({c}, 2) int64 tensor, "
                         f"got {keys.dtype} {tuple(keys.shape)}")
    if isinstance(noise_power, torch.Tensor) and (
            noise_power.dtype != torch.float32 or noise_power.shape != (c,)
            or not noise_power.is_contiguous()):
        raise ValueError(f"a per-row noise_power must be a contiguous ({c},) "
                         "float32 tensor")
    if bits_per_symbol not in (2, 4, 6, 8):
        raise ValueError(f"bits_per_symbol must be 2, 4, 6 or 8, "
                         f"got {bits_per_symbol}")
    if fading not in ac._FADING:
        raise ValueError(f"unknown fading {fading!r}")
    if block_len <= 0:
        raise ValueError("block_len must be positive")
    if s >= 1 << 32:
        raise ValueError("a row holds fewer than 2**32 symbols "
                         "(prng.random_bits' limit)")
    for name, t in (("sym", sym), ("keys", keys), ("noise_power", noise_power)):
        if isinstance(t, torch.Tensor) and (t.device.type != "cuda"
                                            or t.device != sym.device):
            raise ValueError(f"{name} must be on one CUDA device, got "
                             f"{t.device}")


def _f32_cpu(v: float) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def channel_stage(sym: torch.Tensor, keys: torch.Tensor, noise_power,
                  large_scale_gain: float, *, bits_per_symbol: int,
                  fading: str, block_len: int, gain: bool = False):
    """Symbol indices ``(C, S)`` through Gray QAM, the channel and
    zero-forcing in one launch: ``(y, c)``, complex64 ``(C, S)``, ``c`` the
    composite gain where ``gain`` is set, else ``None``.

    Args:
      sym: contiguous ``(C, S)`` int64 symbol indices on a CUDA device, S
        below 2**32.
      keys: contiguous ``(C, 2)`` int64 keys (``uint32`` values), row ``i``
        drawing its fading and noise as ``channel.transmit(.., keys[i])``.
      noise_power: the noise power sigma^2, a Python float for every row
        or a contiguous ``(C,)`` float32 tensor on the same device.
      large_scale_gain: ``p d^-alpha``, a Python float.
      bits_per_symbol / fading / block_len: the scheme and channel.
    """
    _check(sym, keys, noise_power, bits_per_symbol, fading, block_len)
    c, s = sym.shape
    dev = sym.device
    y = torch.empty((c, s), dtype=torch.complex64, device=dev)
    c_out = torch.empty_like(y) if gain else None
    if y.numel() == 0:
        return y, c_out
    # channel._cn's sqrt(float32(var / 2)): per row on the card as there;
    # for a Python float, filled on the card (no host copy) and rooted there
    if isinstance(noise_power, torch.Tensor):
        nscale, step = torch.sqrt(noise_power / 2.0), 1
    else:
        nscale = torch.sqrt(torch.full((1,), noise_power / 2.0,
                                       dtype=torch.float32, device=dev))
        step = 0
    # the fading's sqrt(float32(1.0 / 2)) and transmit's amp, on the host as
    # transmit computes amp (sqrt is correctly rounded on both devices)
    hscale = float(torch.sqrt(_f32_cpu(1.0 / 2.0)))
    gain_amp = float(torch.sqrt(_f32_cpu(large_scale_gain)))
    point_amp, _ = ac._constellation(bits_per_symbol)
    rc = _library().repro_phy_channel_stage(
        sym.data_ptr(), keys.data_ptr(), y.data_ptr(),
        None if c_out is None else c_out.data_ptr(), nscale.data_ptr(), step,
        c, s, bits_per_symbol, ac._FADING[fading], block_len, hscale,
        gain_amp, point_amp, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"channel stage launch failed: cudaError {rc}")
    channel_stage.launches += 1
    return y, c_out


channel_stage.launches = 0


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The kernel's normal of each 32-bit draw in ``bits`` (a contiguous
    int32 CUDA tensor holding ``uint32`` values): its uniform, ``erfinvf``
    and ``* sqrt 2``, as ``prng.normal`` computes them from
    ``random_bits``. A test hook; the stage itself draws in registers."""
    if (bits.dtype != torch.int32 or bits.device.type != "cuda"
            or not bits.is_contiguous()):
        raise ValueError("bits must be a contiguous int32 CUDA tensor, got "
                         f"{bits.dtype} on {bits.device}")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    rc = _library().repro_phy_normal_of_bits(
        bits.data_ptr(), out.data_ptr(), bits.numel(),
        torch.cuda.current_stream(bits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"normal_of_bits launch failed: cudaError {rc}")
    return out
