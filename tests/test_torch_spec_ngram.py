"""Speculative decoding with the model-free ngram drafter against the JAX
reference, on the CPU (helpers and the int8 drafter: ``test_torch_spec.py``):
greedy tokens and acceptance on the paged pool and the dense cache, base
only and with two tenants, EOS landing mid-round, and the acceptance a
settled greedy cycle gives."""

import pytest

from test_torch_spec import check_greedy_parity, run, world  # noqa: F401  (world: the fixture)


@pytest.mark.parametrize("n_tenants", [0, 2], ids=["base", "two_tenants"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_ngram_drafter_greedy_tokens_and_acceptance_match_reference(world, paged, n_tenants):
    check_greedy_parity(world, "ngram", paged, n_tenants)


def test_eos_mid_round_matches_reference(world):
    """EOS inside an accepted prefix on the paged pool, spec_k 2."""
    full, _, _ = run(world, True, draft="off")
    eos = full[3][2]
    want, want_counts, _ = run(world, False, draft="ngram", spec_k=2, eos_id=eos)
    got, counts, _ = run(world, True, draft="ngram", spec_k=2, eos_id=eos)
    assert got == want and counts == want_counts
    assert any(len(g) < len(f) for g, f in zip(got, full))
    assert got == run(world, True, draft="off", eos_id=eos)[0]


def test_ngram_accepts_on_a_settled_cycle(world):
    """Deep into a long greedy stream the output settles into a short
    cycle, which the wrapped lookup proposes in full: acceptance well
    above noise, and the same counts as the reference."""
    kw = dict(draft="ngram", slots=1, max_len=256, requests=[([1, 5, 9, 2], 240)])
    want, want_counts, _ = run(world, False, **kw)
    got, counts, _ = run(world, True, **kw)
    assert got == want and counts == want_counts and len(got[0]) == 240
    assert counts[1] / counts[0] > 0.10
