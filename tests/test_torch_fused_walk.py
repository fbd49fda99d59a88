"""The quantile walk of a fused PERCENTILE batch on the CPU.

``torch_engine.fused_aggregate_batch`` walks every member of a batch at
once: one mid histogram over ``B * P`` partitions, one subtree histogram
(or the byte cap's partition blocks), and node noise keyed by each
member's own tree key and member-local partition at its own scale. Held
here, bit for bit, to each member's solo ``_fused_body`` (Laplace and
Gaussian, one and three quantiles, with privacy ids and with bounds
already enforced, unblocked and blocked walks, members of mixed size and
epsilon) and to the JAX package's ``fused_aggregate_batch_kernel`` on
the same prepared requests, padded with its own ``pad_request_to_bucket``.
"""

import contextlib

import numpy as np
import pytest
import torch

import pipelinedp_tpu_torch as pdp
from pipelinedp_tpu_torch import plan as plan_mod
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.dp_engine import DataExtractors
from pipelinedp_tpu_torch.ops import prng, quantile_tree
from pipelinedp_tpu_torch.ops.kernels import segsum

from test_torch_fusion import _assert_same_arrays, _jax_params

P_PAD = 32
# (rows, epsilon) of each member: three sizes, three budgets.
MEMBERS = ((3_000, 4.0), (1_200, 1.5), (2_500, 8.0))
QUANTILES = {1: (50,), 3: (50, 90, 10)}
# Partitions per block of the walk, forced through the subhist_byte_cap
# seam: None for the default cap (one K3 call for the batch); 8, fewer
# than one member's 32; 64, two whole members to a block.
BLOCKS = {"default": None, "below_member": 8, "across_members": 64}


def percentile_params(noise, q, enforced=False):
    kw = {}
    if enforced:
        kw["contribution_bounds_already_enforced"] = True
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT] +
        [pdp.Metrics.PERCENTILE(p) for p in QUANTILES[q]],
        noise_kind=getattr(pdp.NoiseKind, noise),
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0, **kw)


def member_columns(i, n):
    rng = np.random.default_rng(10 + i)
    return (rng.integers(0, n // 10, n), rng.integers(0, 16, n),
            rng.uniform(0.0, 10.0, n))


def make_preps(config, members):
    preps = []
    for i, (n, eps) in enumerate(members):
        pids, pks, values = member_columns(i, n)
        encoded = te.encode(pdp.ArrayDataset(pids, pks, values),
                            DataExtractors())
        table, thr, s_scale, min_count = te.selection_inputs(config, eps,
                                                             1e-6, None)
        preps.append(te.FusionPrep(
            lazy=None, encoded=encoded, P=len(encoded.pk_vocab),
            P_pad=P_PAD, scales=np.asarray([0.7 / eps], np.float32),
            keep_table=np.asarray(table), thr=float(thr),
            s_scale=float(s_scale), min_count=float(min_count),
            rows_per_uid=1.0, key=prng.PRNGKey(100 + i)))
    return preps


def solo(config, prep, fx_bits):
    pid, pk, values = te.put_on_device(prep.encoded, torch.device("cpu"),
                                       with_values=config.needs_values)
    keep, raw = te._fused_body(config, P_PAD, pid, pk, values, prep.scales,
                               prep.keep_table, prep.thr, prep.s_scale,
                               prep.min_count, prep.rows_per_uid, prep.key,
                               fx_bits)
    return keep.numpy(), {k: v.numpy() for k, v in raw.items()}


def member(batch, i):
    keep, raw = batch
    return keep[i], {k: v[i] for k, v in raw.items()}


@pytest.mark.parametrize("cap", sorted(BLOCKS))
@pytest.mark.parametrize("bounding", ["pids", "enforced"])
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_batch_equals_each_solo_run(noise, q, bounding, cap):
    """Each member of a fused percentile batch: keep mask and every
    column, percentiles included, are its solo run's bits."""
    config = te.FusedConfig.from_params(
        percentile_params(noise, q, bounding == "enforced"), public=False)
    preps = make_preps(config, MEMBERS)
    fx_bits = te.fused_fx_bits(config, 4_096)
    blocks = BLOCKS[cap]
    R = len(MEMBERS) * P_PAD
    with (plan_mod.seam_override("subhist_byte_cap", blocks * q * 256 * 4)
          if blocks else contextlib.nullcontext()):
        assert te._walk_blocks(R, q, 256) == (blocks or R)
        batch = te.fused_aggregate_batch(config, P_PAD, preps, fx_bits,
                                         "cpu")
    names = te._percentile_field_names(QUANTILES[q])
    assert set(names) <= set(batch[1])
    for i, prep in enumerate(preps):
        want = solo(config, prep, fx_bits)
        assert want[0].any()
        assert np.isfinite(want[1][names[0]]).all()
        _assert_same_arrays(want, member(batch, i), f"member {i}")


def test_batch_of_one_member_equals_solo():
    config = te.FusedConfig.from_params(percentile_params("LAPLACE", 3),
                                        public=False)
    prep, = make_preps(config, MEMBERS[:1])
    fx_bits = te.fused_fx_bits(config, 4_096)
    batch = te.fused_aggregate_batch(config, P_PAD, [prep], fx_bits, "cpu")
    _assert_same_arrays(solo(config, prep, fx_bits), member(batch, 0),
                        "member 0")


@pytest.mark.parametrize("P", [1 << 16, 1 << 20, 3 << 18])
def test_walk_members_keep_segments_in_int32(P):
    """One walk takes the most members whose flat mid-histogram segment
    ids ``members * P * n_mid`` stay below 2^31: 8 members at 2^20
    partitions walk as 7 and 1."""
    _, _, n_mid, _ = quantile_tree.tree_constants()
    per = te._walk_members(P)
    assert per * P * n_mid < 1 << 31 <= (per + 1) * P * n_mid
    if P == 1 << 20:
        assert per == 7


@pytest.mark.parametrize("per", [1, 2])
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_batch_past_int32_walks_in_runs(noise, per, monkeypatch):
    """A batch whose segment ids would pass int32, with the limit lowered
    through ``_walk_members`` to ``per`` members a walk: it walks in runs
    of ``per`` members (one mid histogram each) and every member is still
    its solo run's bits."""
    config = te.FusedConfig.from_params(percentile_params(noise, 3),
                                        public=False)
    preps = make_preps(config, MEMBERS)
    fx_bits = te.fused_fx_bits(config, 4_096)
    monkeypatch.setattr(te, "_walk_members", lambda P: per)
    calls = []
    real = segsum.segment_sum_lanes
    monkeypatch.setattr(segsum, "segment_sum_lanes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = te.fused_aggregate_batch(config, P_PAD, preps, fx_bits, "cpu")
    assert len(calls) == 1 + -(-len(MEMBERS) // per)
    monkeypatch.setattr(segsum, "segment_sum_lanes", real)
    for i, prep in enumerate(preps):
        _assert_same_arrays(solo(config, prep, fx_bits), member(batch, i),
                            f"member {i}")


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_batch_against_jax_batch_kernel(noise, q):
    """The JAX package's ``fused_aggregate_batch_kernel`` on the same
    prepared requests, each padded to the bucket's row edge by its own
    ``pad_request_to_bucket``, against the port's unpadded batch.

    Keep and every integer column: bit for bit against the batch kernel.
    Every column, the percentiles included: bit for bit against the JAX
    package's solo kernel on each padded request. XLA compiles the
    vmapped walk to other CPU code than the solo walk, and its float32
    percentiles may differ from the solo program's in a few elements
    (ROADMAP §3); the port's batch is each member's solo program, so it
    is held to the solo bits."""
    import jax
    import jax.numpy as jnp

    import pipelinedp_tpu as jpdp
    from pipelinedp_tpu import jax_engine as je
    from pipelinedp_tpu.serve import fusion as jfusion
    params = percentile_params(noise, q)
    config = te.FusedConfig.from_params(params, public=False)
    config_j = je.FusedConfig.from_params(_jax_params(params), public=False)
    # The JAX batch stacks the keep tables: one budget for every member.
    members = tuple((n, 4.0) for n, _ in MEMBERS)
    preps = make_preps(config, members)
    rows_pad = 4_096
    fx_bits = te.fused_fx_bits(config, rows_pad)
    got = te.fused_aggregate_batch(config, P_PAD, preps, fx_bits, "cpu")
    padded = []
    for i, (n, _) in enumerate(members):
        pids, pks, values = member_columns(i, n)
        encoded_j = je.encode(je.ArrayDataset(pids, pks, values),
                              jpdp.DataExtractors(), None, None)
        np.testing.assert_array_equal(encoded_j.pk, preps[i].encoded.pk)
        padded.append(jfusion.pad_request_to_bucket(
            encoded_j, rows_pad, config_j.needs_values))

    def jax_inputs(pads, chosen):
        stack = (lambda xs: jnp.asarray(np.stack(xs))) if len(
            chosen) > 1 else (lambda xs: jnp.asarray(xs[0]))
        scalars = (lambda name: stack([np.float32(getattr(preps[i], name))
                                       for i in chosen]))
        return ([stack([pads[i][j] for i in chosen]) for j in range(4)] +
                [stack([preps[i].scales for i in chosen]),
                 stack([preps[i].keep_table for i in chosen]),
                 scalars("thr"), scalars("s_scale"), scalars("min_count"),
                 scalars("rows_per_uid"),
                 stack([np.asarray(jax.random.PRNGKey(100 + i))
                        for i in chosen])])

    everyone = list(range(len(members)))
    keep, raw = je.fused_aggregate_batch_kernel(
        config_j, P_PAD, *jax_inputs(padded, everyone), fx_bits=fx_bits)
    batch_j = (np.asarray(keep), {k: np.asarray(v) for k, v in raw.items()})
    names = set(te._percentile_field_names(QUANTILES[q]))
    assert batch_j[0].any() and names <= set(batch_j[1])
    _assert_same_arrays(
        (batch_j[0], {k: v for k, v in batch_j[1].items()
                      if k not in names}),
        (got[0], {k: v for k, v in got[1].items() if k not in names}),
        f"{noise} Q={q} batch")
    for i in everyone:
        keep_s, raw_s = je.fused_aggregate_kernel(
            config_j, P_PAD, *jax_inputs(padded, [i]), fx_bits=fx_bits)
        solo_j = (np.asarray(keep_s), {k: np.asarray(v)
                                       for k, v in raw_s.items()})
        _assert_same_arrays(solo_j, member(got, i), f"member {i} solo")
