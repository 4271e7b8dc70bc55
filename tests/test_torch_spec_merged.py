"""Speculative decoding with the merged (base + mean of tenants) drafter
against the JAX reference, on the CPU (helpers and the int8 drafter:
``test_torch_spec.py``): greedy tokens and acceptance on the paged pool and
the dense cache, base only and with two tenants, and a full cache landing
mid-round under the int8 drafter."""

import pytest

from test_torch_spec import check_greedy_parity, run, world  # noqa: F401  (world: the fixture)


@pytest.mark.parametrize("n_tenants", [0, 2], ids=["base", "two_tenants"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_merged_drafter_greedy_tokens_and_acceptance_match_reference(world, paged, n_tenants):
    check_greedy_parity(world, "merged", paged, n_tenants)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cache_full_mid_round_matches_reference(world, paged):
    """A slot reaching max_len - 1 inside a round: q_len stops at the
    cache's end, emission stops where the per-token loop stops."""
    kw = dict(draft="int8", slots=1, max_len=16, requests=[([1, 5, 9, 2], 64)], paged=paged)
    want, want_counts, _ = run(world, False, **kw)
    got, counts, eng = run(world, True, **kw)
    assert got == want and counts == want_counts
    assert len(got[0]) == 16 - 4  # the prompt ends at pos 4, the cache at 15
    assert got == run(world, True, **dict(kw, draft="off"))[0]
    assert eng.scheduler.in_flight() == [] and eng.kv.drained()
