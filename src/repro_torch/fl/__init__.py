"""Federated learning over the simulated links: the paper's model and
non-iid split (``cnn``, ``partition``), the round engine (``engine``:
FedSGD and FedAvg, scenario dispatches, uplink and downlink legs), its
entry points (``loop.run_fl``, ``fedavg.run_fedavg``) and the buffered
asynchronous engine (``async_engine``: ``run_fl_buffered``,
``run_fedavg_buffered``)."""

from repro_torch.fl import cnn, partition
from repro_torch.fl.async_engine import (AsyncRoundEngine,
                                         run_fedavg_buffered,
                                         run_fl_buffered)
from repro_torch.fl.engine import FedAvg, FedSGD, FLResult, RoundEngine
from repro_torch.fl.fedavg import run_fedavg
from repro_torch.fl.loop import run_fl

__all__ = ["cnn", "partition", "AsyncRoundEngine", "FedAvg", "FedSGD",
           "FLResult", "RoundEngine", "run_fedavg", "run_fedavg_buffered",
           "run_fl", "run_fl_buffered"]
