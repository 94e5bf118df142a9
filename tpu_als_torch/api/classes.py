"""The class names that saves record, and the port's class for each.

A save of either package records the reference's dotted class names
(``"tpu_als.api.estimator.ALSModel"``, the stages of a pipeline, a
tuner's best model, ``"tpu_als.models.two_tower"``), so that each
package loads the other's saves.  The port writes those names for its
own classes and resolves a name read from disk through the fixed table
below: it never imports a dotted path read from disk, and never imports
the JAX package.
"""

from __future__ import annotations

# the saved name -> (module of the port, class name)
_TABLE = {
    "tpu_als.api.estimator.ALS": ("estimator", "ALS"),
    "tpu_als.api.estimator.ALSModel": ("estimator", "ALSModel"),
    "tpu_als.api.pipeline.StringIndexer": ("pipeline", "StringIndexer"),
    "tpu_als.api.pipeline.StringIndexerModel":
        ("pipeline", "StringIndexerModel"),
    "tpu_als.api.pipeline.IndexToString": ("pipeline", "IndexToString"),
    "tpu_als.api.pipeline.Pipeline": ("pipeline", "Pipeline"),
    "tpu_als.api.pipeline.PipelineModel": ("pipeline", "PipelineModel"),
    "tpu_als.api.tuning.CrossValidatorModel":
        ("tuning", "CrossValidatorModel"),
    "tpu_als.api.tuning.TrainValidationSplitModel":
        ("tuning", "TrainValidationSplitModel"),
    # the reference's two-tower saves name the module, not a class
    "tpu_als.models.two_tower": ("two_tower", "TwoTower"),
}

# the classes whose load takes device= (they hold, or fit, factors)
_DEVICE_BOUND = {"ALS", "ALSModel", "Pipeline", "PipelineModel",
                 "CrossValidatorModel", "TrainValidationSplitModel",
                 "TwoTower"}


def _classes():
    from tpu_als_torch.api import estimator, pipeline, tuning
    from tpu_als_torch.models import two_tower

    mods = {"estimator": estimator, "pipeline": pipeline, "tuning": tuning,
            "two_tower": two_tower}
    return {name: getattr(mods[m], cls) for name, (m, cls) in _TABLE.items()}


def saved_name(obj):
    """The name a save records for ``obj``'s class; ValueError for a
    class outside the table (the load side could never read it back)."""
    for name, cls in _classes().items():
        if type(obj) is cls:
            return name
    raise ValueError(
        f"{type(obj).__module__}.{type(obj).__qualname__} has no saved "
        "name: only the API's own classes are persistable (a save of "
        "another class could never be loaded)")


def resolve(name, where):
    """The port's class for the saved name ``name`` (read from
    ``where``); ValueError for a name outside the table."""
    cls = _classes().get(name)
    if cls is None:
        raise ValueError(
            f"refusing to load class {name!r} from {where}: only the API's "
            f"own classes are loadable ({sorted(_TABLE)})")
    return cls


def load(name, path, device=None):
    """Load the save at ``path`` as the class saved under ``name``;
    ``device`` goes to the classes that hold or fit factors."""
    cls = resolve(name, path)
    if cls.__name__ in _DEVICE_BOUND:
        return cls.load(path, device=device)
    return cls.load(path)
