"""MetricsTuple plumbing of the output assembly: a cached namedtuple type
with a custom ``__reduce__`` so instances survive pickling across workers.

Port of the helper of ``pipelinedp_tpu/combiners.py`` that the fused
release uses; the host combiners themselves are ROADMAP step 2.
"""

from __future__ import annotations

import collections

_named_tuple_cache = {}


def _get_or_create_named_tuple(type_name: str, field_names: tuple):
    cache_key = (type_name, field_names)
    named_tuple = _named_tuple_cache.get(cache_key)
    if named_tuple is None:
        named_tuple = collections.namedtuple(type_name, field_names)
        named_tuple.__reduce__ = lambda self: (_create_named_tuple_instance,
                                               (type_name, field_names,
                                                tuple(self)))
        _named_tuple_cache[cache_key] = named_tuple
    return named_tuple


def _create_named_tuple_instance(type_name: str, field_names: tuple, values):
    return _get_or_create_named_tuple(type_name, field_names)(*values)
