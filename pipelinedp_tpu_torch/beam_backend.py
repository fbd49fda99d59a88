"""Apache Beam adapter — importable only when ``apache_beam`` (or a
structurally compatible stand-in registered in ``sys.modules``) is
available. ``pipelinedp_tpu_torch.pipeline_backend`` re-exports
``BeamBackend`` when the import succeeds, mirroring the reference's
optional-dependency behavior (reference
``pipeline_dp/pipeline_backend.py:30-35,219-359``). A port of
``pipelinedp_tpu/beam_backend.py``."""

from __future__ import annotations

import functools

import apache_beam as beam

from pipelinedp_tpu_torch.pipeline_backend import (PipelineBackend,
                                                   UniqueLabelsGenerator,
                                                   _annotators)


class BeamBackend(PipelineBackend):
    """Apache Beam adapter (reference :219-359). Stage labels must be
    globally unique in a Beam pipeline."""

    def __init__(self, suffix: str = ""):
        self._ulg = UniqueLabelsGenerator(suffix)

    @property
    def unique_lable_generator(self):  # reference-parity name
        return self._ulg

    def _label(self, stage_name):
        return self._ulg.unique(stage_name)

    def to_collection(self, collection_or_iterable, col, stage_name):
        if isinstance(collection_or_iterable, beam.PCollection):
            return collection_or_iterable
        return col.pipeline | self._label(stage_name) >> beam.Create(
            collection_or_iterable)

    def map(self, col, fn, stage_name):
        return col | self._label(stage_name) >> beam.Map(fn)

    def flat_map(self, col, fn, stage_name):
        return col | self._label(stage_name) >> beam.FlatMap(fn)

    def map_tuple(self, col, fn, stage_name):
        return col | self._label(stage_name) >> beam.Map(
            lambda x: fn(*x))

    def map_values(self, col, fn, stage_name):
        return col | self._label(stage_name) >> beam.MapTuple(
            lambda k, v: (k, fn(v)))

    def group_by_key(self, col, stage_name):
        return col | self._label(stage_name) >> beam.GroupByKey()

    def filter(self, col, fn, stage_name):
        return col | self._label(stage_name) >> beam.Filter(fn)

    def filter_by_key(self, col, keys_to_keep, stage_name):
        if isinstance(keys_to_keep, (list, set, frozenset)):
            keys = set(keys_to_keep)
            return col | self._label(stage_name) >> beam.Filter(
                lambda kv: kv[0] in keys)

        class _Join(beam.DoFn):

            def process(self, joined):
                key, rest = joined
                if rest["keys"]:
                    for v in rest["values"]:
                        yield key, v

        keys_col = keys_to_keep | self._label(
            f"{stage_name}/keys_kv") >> beam.Map(lambda k: (k, True))
        return ({
            "values": col,
            "keys": keys_col
        }
                | self._label(f"{stage_name}/cogroup") >>
                beam.CoGroupByKey()
                | self._label(f"{stage_name}/join") >> beam.ParDo(
                    _Join()))

    def keys(self, col, stage_name):
        return col | self._label(stage_name) >> beam.Keys()

    def values(self, col, stage_name):
        return col | self._label(stage_name) >> beam.Values()

    def sample_fixed_per_key(self, col, n, stage_name):
        return col | self._label(
            stage_name) >> beam.combiners.Sample.FixedSizePerKey(n)

    def count_per_element(self, col, stage_name):
        return col | self._label(
            stage_name) >> beam.combiners.Count.PerElement()

    def sum_per_key(self, col, stage_name):
        return col | self._label(stage_name) >> beam.CombinePerKey(sum)

    def combine_accumulators_per_key(self, col, combiner, stage_name):

        def merge(accs):
            return functools.reduce(combiner.merge_accumulators, accs)

        return col | self._label(stage_name) >> beam.CombinePerKey(
            merge)

    def reduce_per_key(self, col, fn, stage_name):

        def reduce_all(values):
            return functools.reduce(fn, values)

        return col | self._label(stage_name) >> beam.CombinePerKey(
            reduce_all)

    def flatten(self, cols, stage_name):
        return tuple(cols) | self._label(stage_name) >> beam.Flatten()

    def distinct(self, col, stage_name):
        return col | self._label(stage_name) >> beam.Distinct()

    def to_list(self, col, stage_name):
        return col | self._label(stage_name) >> beam.combiners.ToList()

    def annotate(self, col, stage_name, **kwargs):
        for annotator in _annotators:
            col = annotator.annotate(col, **kwargs)
        return col
