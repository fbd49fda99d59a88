"""Carries the state of a computation across from the JAX package.

The system has no weights: the state of a DP aggregation is its params,
its dataset and its random key. These helpers build the port's objects
from the JAX package's (or any object with the same attribute names)
without importing it, so both packages can compute from the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pipelinedp_tpu_torch import aggregate_params as ap
from pipelinedp_tpu_torch import torch_engine

_ENUM_FIELDS = {
    "noise_kind": ap.NoiseKind,
    "vector_norm_kind": ap.NormKind,
    "partition_selection_strategy": ap.PartitionSelectionStrategy,
}


def _field_value(name: str, value):
    if name in _ENUM_FIELDS and value is not None:
        if isinstance(value, (list, tuple)):
            return [_ENUM_FIELDS[name][v.name] for v in value]
        return _ENUM_FIELDS[name][value.name]
    if name == "metrics":
        return [ap.Metric(m.name, m.parameter) for m in value]
    return value


def params_from_reference(p):
    """The port's ``AggregateParams`` (or ``SelectPartitionsParams``) with
    the field values of ``p``, read by attribute name; enums are matched
    by ``.name`` and metrics by (name, parameter)."""
    cls = (ap.AggregateParams if hasattr(p, "metrics") else
           ap.SelectPartitionsParams)
    kwargs = {f.name: _field_value(f.name, getattr(p, f.name))
              for f in dataclasses.fields(cls) if hasattr(p, f.name)}
    return cls(**kwargs)


def options_from_reference(o):
    """The port's ``UtilityAnalysisOptions`` or ``TuneOptions`` with the
    field values of ``o`` (the params through ``params_from_reference``,
    a ``MultiParameterConfiguration``'s per-config enums by ``.name``)."""
    from pipelinedp_tpu_torch.analysis import (data_structures,
                                               parameter_tuning)

    def same(cls, src, **fields):
        kwargs = {f.name: getattr(src, f.name)
                  for f in dataclasses.fields(cls) if hasattr(src, f.name)}
        kwargs.update(fields)
        return cls(**kwargs)

    fields = dict(aggregate_params=params_from_reference(o.aggregate_params))
    if hasattr(o, "function_to_minimize"):
        fn = o.function_to_minimize
        if hasattr(fn, "name"):
            fn = parameter_tuning.MinimizingFunction[fn.name]
        fields.update(function_to_minimize=fn,
                      parameters_to_tune=same(
                          parameter_tuning.ParametersToTune,
                          o.parameters_to_tune))
        return same(parameter_tuning.TuneOptions, o, **fields)
    multi = o.multi_param_configuration
    if multi is not None:
        cls = data_structures.MultiParameterConfiguration
        fields["multi_param_configuration"] = cls(**{
            f.name: _field_value(f.name, getattr(multi, f.name))
            for f in dataclasses.fields(cls) if hasattr(multi, f.name)})
    return same(data_structures.UtilityAnalysisOptions, o, **fields)


def dataset_from_arrays(privacy_ids, partition_keys,
                        values=None) -> torch_engine.ArrayDataset:
    """An ``ArrayDataset`` over NumPy copies of the columns."""
    return torch_engine.ArrayDataset(
        privacy_ids=(None if privacy_ids is None else
                     np.asarray(privacy_ids)),
        partition_keys=np.asarray(partition_keys),
        values=None if values is None else np.asarray(values))


def key_from_jax(key) -> torch.Tensor:
    """A raw JAX PRNG key (``uint32[2]``, as ``np.asarray`` gives it) as
    the port's key: an int64 tensor ``[2]`` of the same words."""
    words = np.asarray(key, dtype=np.uint32).reshape(2)
    return torch.tensor(words.astype(np.int64), dtype=torch.int64)
