from millieye_torch.runtime.profiler import StageTimer, trace_annotation
from millieye_torch.runtime.engine import FusionEngine
from millieye_torch.runtime.stream import StreamingPipeline, FrameSource
