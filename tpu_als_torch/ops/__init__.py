"""The normal equations, the solves and top-k, and the kernels' wrappers
(``cuda_*``), with the reference's names re-exported
(``tpu_als/ops/__init__.py``).  Importing the package builds and loads
no kernel: each wrapper loads its library at its first launch."""
from tpu_als_torch.ops.solve import (  # noqa: F401
    compute_yty,
    normal_eq_explicit,
    normal_eq_implicit,
    solve_nnls,
    solve_spd,
)
from tpu_als_torch.ops.topk import chunked_topk_scores  # noqa: F401
