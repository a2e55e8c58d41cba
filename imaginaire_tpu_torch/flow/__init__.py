"""FlowNet2 (ref: imaginaire/third_party/flow_net) and the teacher-output
amortization layer (flow/cache.py) of the port."""

from imaginaire_tpu_torch.flow.cache import (
    FlowCacheStore,
    TeacherFlowCache,
    flow_cache_settings,
    resolve_cache_dir,
    transform_flow,
)
from imaginaire_tpu_torch.flow.flow_net import FlowNet
from imaginaire_tpu_torch.flow.flownet2 import (
    FlowNet2,
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
)

__all__ = ["FlowNet", "FlowNet2", "FlowNetC", "FlowNetS", "FlowNetSD",
           "FlowNetFusion", "TeacherFlowCache", "FlowCacheStore",
           "flow_cache_settings", "resolve_cache_dir", "transform_flow"]
