"""Ensemble (scenario-batch) parallelism.

The DP analog for this workload (SURVEY.md §2.17): vmap the whole Preissmann
step over a batch of scenarios (per-member roughness fields, inflow series,
boundary parameters) and shard the batch axis across the device mesh.  The
reference's serial calibration loop (ref n_calibrate.py:58-62) and any
Monte-Carlo study become one sharded batched simulation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.parallel.mesh import ENSEMBLE_AXIS, make_mesh


def shard_batch(x, mesh: Optional[Mesh] = None):
    """Place a batch-leading array (or pytree) on the ensemble mesh axis.

    With a multi-process mesh every process must pass the same full host
    values; each process contributes its addressable slice.  (device_put's
    cross-process equality check is avoided deliberately — it compares
    values elementwise, so identical NaN-carrying leaves, e.g. a
    BoundaryParams' unused initial_depth, would spuriously fail.)
    """
    mesh = mesh or make_mesh()
    sh = NamedSharding(mesh, P(ENSEMBLE_AXIS))
    if jax.process_count() > 1:
        def put(a):
            a = np.asarray(a)
            return jax.make_array_from_process_local_data(
                sh, a, global_shape=a.shape)
    else:
        def put(a):
            return jax.device_put(a, sh)
    return jax.tree_util.tree_map(put, x)


def batch_boundaries(bcs):
    """Stack per-member BoundaryParams into one batched params pytree.

    All members must share the static configuration (kind, presence of
    rating/storage); array leaves gain a leading batch axis.  Returns
    ``(stacked_params, in_axes)`` where ``in_axes`` is the pytree to pass as
    the boundary's vmap axis (0 on every leaf).

    This is what upgrades the reference's serial inflow/roughness sweeps
    (ref n_calibrate.py:58-62, one full re-simulation per member) to a single
    batched run with per-member hydrographs, rating coefficients, and storage
    parameters (e.g. 10^4 roughness/inflow scenarios).
    """
    kinds = {b.kind for b in bcs}
    if len(kinds) != 1:
        raise ValueError(f"all members must share the boundary kind, got {kinds}")
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *bcs)
    axes = jax.tree_util.tree_map(lambda _: 0, bcs[0])
    return stacked, axes


def batched_simulate(geo_batch, us_bc, ds_bc, h0, Q0, settings: prs.PreissmannSettings,
                     mesh: Optional[Mesh] = None, shard: bool = True,
                     us_axes=None, ds_axes=None, chunk_size: Optional[int] = None,
                     lateral_inflow=None):
    """Simulate a batch of scenarios differing in geometry (e.g. roughness)
    and, optionally, boundary forcing.

    ``geo_batch`` has a leading batch dim on every leaf; ICs may be shared
    (broadcast) or batched likewise.  Per-member boundaries: pass the stacked
    params + axes from :func:`batch_boundaries` as ``us_bc``/``us_axes``
    (likewise downstream); with ``us_axes=None`` the boundary is shared.

    ``chunk_size``: run the batch as sequential vmapped chunks inside one
    jit (``lax.map``), which bounds the working set of a large ensemble.
    Requires the batch size to be a multiple of ``chunk_size``.
    """
    # lateral_inflow: shared [N], per-member [B, N] constants, or per-member
    # time-varying [B, nt, N] (express a shared time-varying inflow by
    # broadcasting — a 2D argument is member-major at this entry)
    q = lateral_inflow
    q_ax = 0 if (q is not None and jnp.ndim(q) >= 2) else None
    B_all = jax.tree_util.tree_leaves(geo_batch)[0].shape[0]
    if (q is not None and jnp.ndim(q) == 2
            and B_all == settings.n_time_levels
            and q.shape[0] == B_all):
        # member-major [B, N] and a shared time-varying [nt, N] field are
        # indistinguishable when B == nt — refuse rather than silently pick
        # member-major
        raise ValueError(
            f"2-D lateral_inflow is ambiguous when the member count equals "
            f"the level count (B={B_all} == nt={settings.n_time_levels}): "
            f"broadcast to [B, nt, N] to disambiguate")

    def one(geo, us, ds, h, Q, qm=None):
        return prs.simulate(geo, us, ds, h, Q, settings, lateral_inflow=qm)

    in_axes = (0, us_axes, ds_axes,
               0 if jnp.ndim(h0) > 1 else None, 0 if jnp.ndim(Q0) > 1 else None,
               q_ax)

    B = jax.tree_util.tree_leaves(geo_batch)[0].shape[0]
    if chunk_size is not None and B > chunk_size:
        if B % chunk_size:
            raise ValueError(f"batch {B} not divisible by chunk_size {chunk_size}")
        nch = B // chunk_size

        def chunked(tree):
            return jax.tree_util.tree_map(
                lambda a: a.reshape((nch, chunk_size) + a.shape[1:]), tree)

        def shard_inner(tree):
            m = mesh or make_mesh()
            sh = NamedSharding(m, P(None, ENSEMBLE_AXIS))
            return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)

        prep = (lambda t: shard_inner(chunked(t))) if shard else chunked
        mapped = {"geo": prep(geo_batch)}
        if us_axes is not None:
            mapped["us"] = prep(us_bc)
        if ds_axes is not None:
            mapped["ds"] = prep(ds_bc)
        if jnp.ndim(h0) > 1:
            mapped["h0"] = prep(h0)
        if jnp.ndim(Q0) > 1:
            mapped["Q0"] = prep(Q0)
        if q_ax is not None:
            mapped["q"] = prep(jnp.asarray(q))

        def run_chunk(m):
            return jax.vmap(one, in_axes=in_axes)(
                m["geo"], m.get("us", us_bc), m.get("ds", ds_bc),
                m.get("h0", h0), m.get("Q0", Q0), m.get("q", q))

        # no outer jit (fresh closure per call would recompile every time —
        # same defect as the non-chunked path); lax.map's body traces into
        # the cached prs.simulate jit
        out = jax.lax.map(run_chunk, mapped)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((B,) + a.shape[2:]), out)

    if shard:
        geo_batch = shard_batch(geo_batch, mesh)
        if us_axes is not None:
            us_bc = shard_batch(us_bc, mesh)
        if ds_axes is not None:
            ds_bc = shard_batch(ds_bc, mesh)
        if q_ax is not None:
            q = shard_batch(jnp.asarray(q), mesh)

    # no outer jit: `one` is a fresh closure per call, so jit(vmap(one))
    # would retrace+recompile every time; prs.simulate's own cached jit
    # compiles the batched executable once (see batched_simulate_network)
    return jax.vmap(one, in_axes=in_axes)(geo_batch, us_bc, ds_bc, h0, Q0, q)


def stack_geometries(geos):
    """Stack per-member geometry pytrees into one batched pytree."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *geos)


def batched_simulate_network(branches, n_junctions, settings, batch,
                             Y0=None, junction_area=None, junction_rating=None,
                             mesh: Optional[Mesh] = None, shard: bool = False,
                             engine: str = "loop"):
    """Monte-Carlo over a river NETWORK: vmap
    :func:`flowsim_tpu.ops.network.simulate_network` over per-member branch
    overrides (roughness ensembles, inflow scenarios, initial states) — the
    network counterpart of :func:`batched_simulate`.

    ``batch``: one dict per branch, keyed by BranchDef field names
    (``geo``, ``us``, ``ds``, ``h0``, ``Q0``); each value is a stacked
    pytree with a leading member axis (build with
    :func:`roughness_ensemble`, :func:`batch_boundaries`, or ``jnp.stack``).
    Absent keys are shared across members; junction ends (``us``/``ds``
    given as ints) cannot be overridden.  Junction config (``Y0``,
    ``junction_area``, ``junction_rating``) is shared.

    ``shard=True`` spreads the member axis over the mesh's ensemble axis
    before the vmapped run (one device slice per shard, as in
    :func:`batched_simulate`).
    """
    from flowsim_tpu.ops import network as net

    if len(batch) != len(branches):
        raise ValueError(
            f"batch has {len(batch)} entries for {len(branches)} branches; "
            "pass one dict per branch (empty dict() for unbatched branches)")
    fields = {f.name for f in dataclasses.fields(net.BranchDef)}
    for d in batch:
        for k, v in d.items():
            if k not in fields:
                raise ValueError(f"unknown BranchDef override {k!r}")
            if k in ("us", "ds") and isinstance(v, (int, np.integer)):
                raise ValueError(
                    "junction ends cannot be overridden per member")
            if k == "dx":
                raise ValueError("dx is static; rebuild the branches instead")

    def run(parts):
        brs = [dataclasses.replace(br, **p)
               for br, p in zip(branches, parts)]
        return net.simulate_network(brs, n_junctions, settings, Y0=Y0,
                                    junction_area=junction_area,
                                    junction_rating=junction_rating,
                                    engine=engine)

    if shard:
        batch = shard_batch(batch, mesh)
    # NO outer jit: a fresh jit(vmap(run)) object would recompile on every
    # call (measured: a flat ~5.7 s per call on CPU regardless of M).  The
    # inner simulate_network dispatches through its own cached jit, whose
    # batching rule compiles the vmapped executable once per (topology,
    # settings, batch structure); the outer vmap retrace is pure Python and
    # cheap.
    return jax.vmap(run)(batch)


def roughness_ensemble(geo, n_values):
    """Batched geometry with per-member main-channel roughness."""
    n_values = jnp.asarray(n_values)

    def set_n(n):
        return dataclasses.replace(
            geo, n_main=jnp.broadcast_to(n, geo.n_main.shape).astype(geo.n_main.dtype)
        )

    return jax.vmap(set_n)(n_values)


def table_roughness_ensemble(geo, n_values, n_base=None):
    """Batched :class:`TableGeometry` with per-member uniform roughness.

    Irregular-section tables bake Manning n into the conveyance columns at
    build time (geometry_tables.build_table_geometry), so a per-member
    roughness is applied as an exact rescale: with ``s = n / n_base``,
    Manning K = A R^(2/3) / n gives ``K -> K/s``, ``dK_dA -> dK_dA/s`` and
    the Horton-Einstein equivalent n (linear in the subsection n's when all
    scale together, ref cross_section.py:443-501) gives ``n_eq -> s*n_eq``.
    A/P/R/T columns are pure geometry and are shared across members.

    ``n_base`` defaults to the build-time main-channel n recorded on the
    geometry (``geo.n_ref``); passing a different value is rejected — the
    rescale is silently wrong physics when anchored off the baked n.
    """
    n_ref = getattr(geo, "n_ref", None)
    if n_base is None:
        if n_ref is None:
            raise ValueError(
                "geo does not record its build-time Manning n (stations "
                "disagreed, or the geometry predates n_ref); pass n_base "
                "explicitly — it MUST be the n baked into the tables")
        n_base = n_ref
    elif n_ref is not None and abs(n_base - n_ref) > 1e-12 * abs(n_ref):
        raise ValueError(
            f"n_base={n_base} does not match the Manning n baked into the "
            f"tables at build time (geo.n_ref={n_ref}); the rescale would "
            f"be uniformly mis-scaled")
    n_values = jnp.asarray(n_values)

    def set_n(n):
        s = (n / n_base).astype(geo.conveyance.dtype)
        return dataclasses.replace(
            geo,
            conveyance=geo.conveyance / s,
            dK_dA=geo.dK_dA / s,
            n_eq=geo.n_eq * s,
        )

    out = jax.vmap(set_n)(n_values)
    # the batch no longer has a single baked n (each member's is its own
    # n value) — clear the anchor so a second rescale can't silently
    # anchor off the original build-time value
    return dataclasses.replace(out, n_ref=None)
