from tpu_als_torch.api.estimator import ALS, ALSModel  # noqa: F401
from tpu_als_torch.api.evaluation import (  # noqa: F401
    RankingEvaluator,
    RankingMetrics,
    RegressionMetrics,
    RegressionEvaluator,
)
from tpu_als_torch.api.params import Param, Params, TypeConverters  # noqa: F401
from tpu_als_torch.api.pipeline import (  # noqa: F401
    IndexToString,
    Pipeline,
    PipelineModel,
    StringIndexer,
    StringIndexerModel,
)
from tpu_als_torch.api.tuning import (  # noqa: F401
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from tpu_als_torch.api import legacy  # noqa: F401
