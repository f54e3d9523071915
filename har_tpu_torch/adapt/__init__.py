"""Online adaptation: the closed loop that keeps a deployed fleet's
model matched to its drifting input distribution.

The paper's deployment scenario — continuous monitoring of elderly
wearers — is exactly where a frozen classifier decays (remounted
sensors, gait changes, new users).  ``har_tpu_torch.monitoring`` detects the
decay per session and ``har_tpu_torch.serve`` serves one compiled model
forever; this package closes the loop between them:

  registry.py   versioned model lineage (monotone ids, parent hashes,
                data fingerprints, atomic current pointer,
                promote/rollback/prune)
  trigger.py    fleet-level drift aggregation → debounced RetrainJob
                (K sessions, common channels, onset-deduplicated,
                hysteresis on recovery) + bounded replay buffer
  shadow.py     candidate scoring on mirrored live dispatches
                (bounded fraction, off the serving critical path) with
                promotion gates
  swap.py       the AdaptationEngine controller: retrain → shadow →
                zero-drop hot-swap at a dispatch boundary → probation
                with automatic rollback
  smoke.py      the release gate's end-to-end loop check

Port of ``har_tpu/adapt``: the controller, trigger, shadow gates and
registry are host code copied with their imports renamed (the JAX
package's docs/adaptation.md describes the architecture); the models
they move score on their own device, and the registry loads a version
on the device its caller names (``load_version``).
"""

from har_tpu_torch.adapt.registry import (
    ModelRegistry,
    ModelVersion,
    data_fingerprint,
    load_version,
    register_classical,
    register_neural,
)
from har_tpu_torch.adapt.shadow import ShadowConfig, ShadowEvaluator
from har_tpu_torch.adapt.smoke import adapt_smoke
from har_tpu_torch.adapt.swap import (
    AdaptationConfig,
    AdaptationEngine,
    RetrainPending,
)
from har_tpu_torch.adapt.trigger import (
    DriftAggregator,
    ReplayBuffer,
    RetrainJob,
    RetrainTrigger,
    TriggerConfig,
)

__all__ = [
    "AdaptationConfig",
    "AdaptationEngine",
    "DriftAggregator",
    "ModelRegistry",
    "ModelVersion",
    "ReplayBuffer",
    "RetrainJob",
    "RetrainPending",
    "RetrainTrigger",
    "ShadowConfig",
    "ShadowEvaluator",
    "TriggerConfig",
    "adapt_smoke",
    "data_fingerprint",
    "load_version",
    "register_classical",
    "register_neural",
]
