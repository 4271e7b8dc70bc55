"""Speculative decoding with the NF4 self-drafter against the JAX
reference, on the CPU (helpers and the int8 drafter: ``test_torch_spec.py``):
greedy tokens and acceptance on the paged pool and the dense cache, base
only and with two tenants, and EOS landing mid-round on the dense cache."""

import pytest

from test_torch_spec import check_greedy_parity, run, world  # noqa: F401  (world: the fixture)


@pytest.mark.parametrize("n_tenants", [0, 2], ids=["base", "two_tenants"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_nf4_drafter_greedy_tokens_and_acceptance_match_reference(world, paged, n_tenants):
    check_greedy_parity(world, "nf4", paged, n_tenants)


def test_eos_mid_round_matches_reference(world):
    """EOS inside an accepted prefix: the trigger is emitted and the rest
    of the round rolls back, where the per-token loop stops (dense cache;
    the paged pool's case is in ``test_torch_spec_ngram.py``)."""
    full, _, _ = run(world, True, draft="off", paged=False)
    eos = full[2][4]  # a token greedy decode emits mid-stream
    kw = dict(draft="nf4", spec_k=3, eos_id=eos, paged=False)
    want, want_counts, _ = run(world, False, **kw)
    got, counts, _ = run(world, True, **kw)
    assert got == want and counts == want_counts
    assert any(len(g) < len(f) for g, f in zip(got, full))
    assert got == run(world, True, **dict(kw, draft="off"))[0]
