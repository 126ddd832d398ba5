"""The port's registry docs (``repro_torch.docs``): each of its five tables
equals the reference's ``repro.docs`` table row for row (the port
registers the reference's attacks, aggregators, strategies, codecs and
staleness policies with the same specs), both packages' ``--check`` pass
on the README, and the two sets of markers are distinct.

Serial time about 10 s (mostly imports).
"""
import os

import pytest
import torch

from repro import docs as ref_docs
from repro_torch import docs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
README = os.path.join(ROOT, "README.md")


@pytest.mark.parametrize("name", list(ref_docs.TABLES))
def test_port_table_equals_the_reference_row_for_row(name):
    assert list(docs.TABLES) == list(ref_docs.TABLES)
    ours, theirs = docs.TABLES[name]().splitlines(), ref_docs.TABLES[name]().splitlines()
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs) and not differ, differ


@pytest.mark.parametrize("mod", [docs, ref_docs], ids=["repro_torch", "repro"])
def test_check_passes_on_the_readme(mod):
    assert mod.check(README) == []
    assert mod.main(["--check", "--readme", README]) == 0


def test_markers_are_distinct_and_drift_is_caught(tmp_path):
    """Each package's markers appear once in the README and neither's
    rendering touches the other's blocks; an edited port table fails the
    port's check only."""
    with open(README) as f:
        text = f.read()
    for name in docs.TABLES:
        for mod in (docs, ref_docs):
            assert text.count(mod.BEGIN.format(name=name)) == 1
            assert text.count(mod.END.format(name=name)) == 1
        assert docs.BEGIN.format(name=name) != ref_docs.BEGIN.format(name=name)
    assert docs.render(text) == text and ref_docs.render(text) == text
    begin = docs.BEGIN.format(name="attacks")
    drifted = tmp_path / "README.md"
    drifted.write_text(text.replace(begin + "\n", begin + "\n| stale | row |\n", 1))
    assert docs.check(str(drifted)) and ref_docs.check(str(drifted)) == []
