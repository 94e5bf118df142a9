"""``tpu_als_torch.perf`` — the measurement tools.

:mod:`.roofline` prices one ALS iteration stage by stage (bytes moved
against FLOPs) at the H100's rates, and holds the kernels' bounds;
:mod:`.attribution` measures where an iteration's time goes, stage by
stage; :mod:`.ne_audit` counts the bytes a normal-equation build
gathers and the bytes its kernels declare; :mod:`.autotune` times the
training path's kernel knobs for the planner.
"""

from tpu_als_torch.perf.roofline import (  # noqa: F401
    HEADLINE,
    Stage,
    render,
    roofline,
)
