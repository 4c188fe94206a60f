"""On the card: one short run of each cell kind through the command line.
Skips without a card (decided inside the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from splatbench.tests.tiny import REPO


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dense_5m.render", "headline_1m.train"])
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run([sys.executable, "splatbench/run.py", "--workload", name, "--seed", "3000000019",
                          "--seconds", "2", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
