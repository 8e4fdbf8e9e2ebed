"""Headline-claim consistency: every model-accuracy number in README.md
and docs/training_quality/README.md must equal the committed artifact it
quotes, so a stale claim fails the suite instead of shipping.
"""
import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readme():
    with open(os.path.join(REPO, "README.md")) as f:
        return f.read()


def _headline_row(readme, label):
    for line in readme.splitlines():
        if line.startswith("|") and label in line.split("|")[1]:
            return line
    raise AssertionError("README headline table has no row: " + label)


def _numbers(text):
    """All numbers in a table cell, commas stripped ('1,752,542' -> 1752542)."""
    return [float(t.replace(",", ""))
            for t in re.findall(r"\d[\d,]*\.?\d*", text.replace("~", ""))]


def test_synth_scale_claims_match_artifact():
    """The trainer-at-reference-scale row (README + training-quality doc)
    must equal the committed synthetic-run and oracle artifacts."""
    tq = os.path.join(REPO, "docs", "training_quality")
    with open(os.path.join(tq, "r5_synth_summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(tq, "r5_oracle.json")) as f:
        oracle = json.load(f)
    acc = summary["test_best"]["mean_accuracy"]
    assert summary["test_best"]["scored"] == summary["n_test_reads"], \
        "every synthetic test read must score"
    row = _headline_row(_readme(), "reference scale")
    nums = _numbers(row.split("|")[2])
    assert acc in nums, "README synth row must quote the artifact accuracy"
    assert oracle["oracle_mean_accuracy"] in nums, \
        "README synth row must quote the committed oracle ceiling"
    with open(os.path.join(tq, "README.md")) as f:
        doc = f.read()
    assert ("%.4f" % acc) in doc and \
        ("%.4f" % oracle["oracle_mean_accuracy"]) in doc


def test_training_quality_claims_match_artifact():
    """The fine-tuning numbers quoted in docs/training_quality/README.md's
    round-5 section must equal the committed cv_summary artifact."""
    art = os.path.join(REPO, "docs", "training_quality",
                       "r5_cv_summary.json")
    doc = os.path.join(REPO, "docs", "training_quality", "README.md")
    if not os.path.exists(art):
        pytest.skip("round-5 CV artifact not yet committed")
    with open(art) as f:
        summary = json.load(f)
    with open(doc) as f:
        text = f.read()
    assert "RETRACTED" in text, \
        "the circular round-4 headline must stay retracted"
    for fold in summary["folds"]:
        token = "{:+.4f}".format(fold["delta_mean"])
        assert token in text, \
            "fold {} mean delta {} not quoted in README".format(
                fold["fold"], token)
    assert "{:+.4f}".format(summary["mean_delta"]) in text
