"""Diffusion serving: TALoRA-merged weight bank + continuous-batched engine
(port of ``repro.serving``)."""
from repro_torch.serving.engine import DiffusionServingEngine, VirtualClock
from repro_torch.serving.scheduler import (ContinuousBatcher, GenRequest,
                                           RequestState)
from repro_torch.serving.weight_bank import (Segment, WeightBank,
                                             absmax_talora_setup,
                                             act_qps_from_plan,
                                             default_serving_plan,
                                             segments_of)

__all__ = ["DiffusionServingEngine", "VirtualClock", "ContinuousBatcher",
           "GenRequest", "RequestState", "Segment", "WeightBank",
           "absmax_talora_setup", "act_qps_from_plan", "default_serving_plan",
           "segments_of"]
