"""The training core: id maps and bucketed CSR (:mod:`.ratings`), the
training loop (:mod:`.als`) and fold-in (:mod:`.foldin`), with the
reference's names re-exported (``tpu_als/core/__init__.py``)."""
from tpu_als_torch.core.ratings import (  # noqa: F401
    Bucket,
    CsrBuckets,
    IdMap,
    build_csr_buckets,
    remap_ids,
)
from tpu_als_torch.core.als import AlsConfig, predict, train  # noqa: F401
from tpu_als_torch.core.foldin import fold_in  # noqa: F401
