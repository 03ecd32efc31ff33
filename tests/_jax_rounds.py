"""The JAX package's sharded RBCD rounds by their reference semantics,
for the port's tests: `rbcd_round_reference` over all robots, then the
GNC update every `every` rounds from round `burnin`
(tests/test_rbcd_dist.py holds `dist.rounds.make_round_fn` equal to
these). Without `shard_map`: the JAX package's in-process CPU collectives
abort now and then (SIGABRT inside `round_fn`, tests/test_rbcd_dist.py's
own runs included) when several test processes load the machine, so the
port's long comparisons run this form."""

import jax
import jax.numpy as jnp

from kimera_multi_tpu.solve import gnc, rbcd


def reference_rounds(edges, Y0, cfg, ppr: int, n: int, every: int,
                     burnin: int = 6, init_weights=None, buckets=None):
    """`n` rounds from Y0, GNC seeded at Y0 (weights `init_weights` when
    given, as `rounds.init_state`). Returns (Y, GncState)."""
    sq = lambda Y: rbcd.lifted_edge_sq_errors(  # noqa: E731
        Y.reshape(-1, *Y.shape[2:]), edges, ppr)
    st = gnc.gnc_init(sq(Y0), edges.etype, edges.valid,
                      gnc.barc2_from_quantile(0.9, dof=6))
    if init_weights is not None:
        st = st.replace(weights=init_weights)
    act = jnp.ones(Y0.shape[0], bool)
    step = jax.jit(lambda Y, w: rbcd.rbcd_round_reference(
        Y, act, edges, w, cfg, ppr, buckets))
    upd = jax.jit(lambda s, Y: gnc.gnc_update_weights(
        s, sq(Y), edges.etype, edges.valid, mu_factor=1.4))
    Y = Y0
    for i in range(n):
        Y = step(Y, st.weights)
        if (i + 1) % every == 0 and i + 1 >= burnin:
            st = upd(st, Y)
    return Y, st
