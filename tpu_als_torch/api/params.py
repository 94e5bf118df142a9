"""The Param/Params system — the ``pyspark.ml.param`` surface.

Counterpart of ``tpu_als/api/params.py`` (an own copy; the port imports
nothing of the JAX package): ``Param`` descriptors, ``TypeConverters``,
the ``Params`` mixin with default and user param maps (``getOrDefault``
precedence, ``copy(extra)``, ``extractParamMap``, ``hasDefault``/
``isSet``/``isDefined``, ``explainParams``), and the ``Estimator`` base
with the ``fit``/``fitMultiple`` param-map overloads.
"""

from __future__ import annotations

import copy as _copy


class Param:
    """A named parameter attached to a Params instance."""

    def __init__(self, parent, name, doc, typeConverter=None):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda x: x)

    def __repr__(self):
        return f"{type(self.parent).__name__}__{self.name}"

    def __hash__(self):
        return hash((type(self.parent), self.name))

    def __eq__(self, other):
        return (
            isinstance(other, Param)
            and type(self.parent) is type(other.parent)
            and self.name == other.name
        )


# -- type converters (subset of pyspark.ml.param.TypeConverters) ----------
class TypeConverters:
    @staticmethod
    def toInt(v):
        if isinstance(v, bool) or int(v) != v:
            raise TypeError(f"could not convert {v!r} to int")
        return int(v)

    @staticmethod
    def toFloat(v):
        return float(v)

    @staticmethod
    def toBoolean(v):
        if not isinstance(v, (bool,)):
            raise TypeError(f"boolean param got {v!r}")
        return bool(v)

    @staticmethod
    def toString(v):
        return str(v)


class Params:
    """Mixin holding a default param map and a user-set param map."""

    def __init__(self):
        self._paramMap = {}
        self._defaultParamMap = {}

    # -- declaration helpers ------------------------------------------
    def _declareParam(self, name, doc, typeConverter=None, default=None):
        p = Param(self, name, doc, typeConverter)
        setattr(self, name, p)
        if default is not None:
            self._defaultParamMap[p] = default
        return p

    def _setDefault(self, **kwargs):
        for name, value in kwargs.items():
            self._defaultParamMap[self.getParam(name)] = value
        return self

    # -- the pyspark.ml surface ---------------------------------------
    @property
    def params(self):
        # Param descriptors are instance attributes (set by _declareParam);
        # scanning dir()/getattr here would re-enter this property forever.
        return sorted(
            (v for v in self.__dict__.values() if isinstance(v, Param)),
            key=lambda p: p.name,
        )

    def getParam(self, name):
        p = getattr(self, name, None)
        if not isinstance(p, Param):
            raise ValueError(f"no param named {name!r}")
        return p

    def hasParam(self, name):
        return isinstance(getattr(self, name, None), Param)

    def isSet(self, param):
        return self._resolve(param) in self._paramMap

    def hasDefault(self, param):
        return self._resolve(param) in self._defaultParamMap

    def isDefined(self, param):
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param):
        p = self._resolve(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"param {p.name} is not set and has no default")

    def set(self, param, value):
        p = self._resolve(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            if value is not None:
                self.set(self.getParam(name), value)
        return self

    def clear(self, param):
        self._paramMap.pop(self._resolve(param), None)
        return self

    def extractParamMap(self, extra=None):
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            m.update({self._resolve(k): v for k, v in extra.items()})
        return m

    def explainParam(self, param):
        p = self._resolve(param)
        parts = [f"default: {self._defaultParamMap.get(p)}"]
        if p in self._paramMap:
            parts.append(f"current: {self._paramMap[p]}")
        return f"{p.name}: {p.doc} ({', '.join(parts)})"

    def explainParams(self):
        return "\n".join(self.explainParam(p) for p in self.params)

    def copy(self, extra=None):
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        # re-bind Param descriptors to the copy so grids keyed on the
        # original's params still resolve (matching pyspark semantics of
        # resolving by parent type + name)
        if extra:
            for k, v in extra.items():
                that.set(k, v)
        return that

    def _resolve(self, param):
        """Accept this instance's Param, a same-shaped Param from a copy,
        or a param name."""
        if isinstance(param, str):
            return self.getParam(param)
        if isinstance(param, Param):
            own = getattr(self, param.name, None)
            if isinstance(own, Param):
                return own
            raise ValueError(f"{type(self).__name__} has no param {param.name}")
        raise TypeError(f"expected Param or str, got {param!r}")


class Estimator(Params):
    """Shared ``fit``/``fitMultiple`` param-map overloads (reference
    ``python/pyspark/ml/base.py``): subclasses implement ``_fit(dataset)``
    and inherit the whole overload surface, so the TypeError contract and
    the fitMultiple snapshot semantics exist in exactly one place."""

    def fit(self, dataset, params=None):
        if isinstance(params, (list, tuple)):
            models = [None] * len(params)
            for i, m in self.fitMultiple(dataset, params):
                models[i] = m
            return models
        if params is None or isinstance(params, dict):
            est = self.copy(params) if params else self
            return est._fit(dataset)
        raise TypeError(
            "params must be either a param map (dict) or a list/tuple "
            f"of param maps, got {type(params).__name__}")

    def fitMultiple(self, dataset, paramMaps):
        """Thread-safe iterator of ``(index, model)`` — one per param
        map, fit against a SNAPSHOT of this estimator taken now (later
        mutations of ``self`` do not leak into pending fits, per the
        reference contract).  Index allocation is locked; the fits
        themselves run outside the lock so callers may drain the
        iterator from several threads."""
        import threading

        est = self.copy()
        maps = list(paramMaps)
        lock = threading.Lock()
        counter = {"i": 0}

        class _FitIter:
            def __iter__(self):
                return self

            def __next__(self):
                with lock:
                    i = counter["i"]
                    if i >= len(maps):
                        raise StopIteration
                    counter["i"] = i + 1
                return i, est.copy(maps[i])._fit(dataset)

        return _FitIter()
