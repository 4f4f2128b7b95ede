"""The paper's own FL model: 2xconv(k5) + 2xmaxpool(2) + 2xFC on 28x28
digits, ReLU hidden, log-softmax output, eta=0.01 (paper Sec. V)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class MnistCnnConfig:
    image_size: int = 28
    conv_channels: tuple = (10, 20)
    kernel: int = 5
    fc_hidden: int = 50
    n_classes: int = 10
    lr: float = 0.01


def config() -> MnistCnnConfig:
    return MnistCnnConfig()
