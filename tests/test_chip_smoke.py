"""chip_smoke.py's parts that run without a GPU: it refuses to run on
the CPU, and --four-cards selects the sharded phase alone."""
import json

import jax
import pytest

import chip_smoke


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_refuses_cpu(argv, capsys, cache_config):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert last["ok"] is False
    assert "GPU" in last["error"]


@pytest.mark.parametrize("four_cards,expect", [
    (False, ["phase_headline", "phase_reference", "phase_advance"]),
    (True, ["phase_four_cards"]),
])
def test_phase_selection(four_cards, expect):
    assert [f.__name__ for f in chip_smoke.phases(four_cards)] == expect
