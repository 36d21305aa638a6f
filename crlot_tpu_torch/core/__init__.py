from .types import (  # noqa: F401
    BoundaryMode,
    FftBackend,
    FftDomain,
    FftPlanDesc,
    FrameSpec,
    NormalizationType,
    OLAConfig,
    PadMode,
    StftConfig,
    WindowType,
)
