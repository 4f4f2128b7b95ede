"""Link adaptation (port): time-varying channels, noisy CSI, per-client
mode policy and named scenarios, the counterpart of ``repro.link``.

Channel state evolves per round (:mod:`repro_torch.link.dynamics`), the PS
estimates it from pilots (:mod:`repro_torch.link.estimator`), a hysteresis
policy picks each client's transport mode (:mod:`repro_torch.link.policy`),
and named scenarios drive the FL engine (:mod:`repro_torch.link.scenario`).
"""

from repro_torch.link.dynamics import (  # noqa: F401
    DYNAMICS_PRESETS,
    LinkDynamicsConfig,
    LinkState,
    jakes_rho,
)
from repro_torch.link.estimator import (  # noqa: F401
    EstimatorConfig,
    estimate_snr_db,
)
from repro_torch.link.policy import (  # noqa: F401
    PolicyConfig,
    build_mode_cfgs,
    choose_mode,
    downlink_mode,
    ecrt_anchor_snr_db,
    fixed_policy,
)
from repro_torch.link.scenario import (  # noqa: F401
    SCENARIOS,
    DownlinkConfig,
    LinkRound,
    Scenario,
    ScenarioDriver,
    get_scenario,
    list_scenarios,
    register_scenario,
)
