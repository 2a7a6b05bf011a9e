"""chip_smoke.py's phases at small sizes, on the card.

Run on a GPU host with ``SA_TEST_PLATFORM=gpu pytest tests/test_gpu.py -m gpu``;
elsewhere every test here skips through the ``gpu`` fixture.
"""

import concurrent.futures
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

MiB = 1 << 20


@pytest.fixture
def smoke(gpu):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.fixture
def pool():
    with concurrent.futures.ThreadPoolExecutor(4) as p:
        yield p


def _corpus(smoke, pool, name, n):
    text = smoke.family_text(name, n)
    return text, pool.submit(smoke.oracle, text)


@pytest.mark.gpu
def test_gpu_cli(smoke, pool, tmp_path):
    rec = smoke.phase_cli(*_corpus(smoke, pool, "random", 16 * MiB),
                          str(tmp_path))
    assert rec["path"] in smoke.DEVICE_PATHS


@pytest.mark.gpu
def test_gpu_headline_sa_lcp(smoke, pool):
    rec = smoke.phase_headline(*_corpus(smoke, pool, "random", 16 * MiB))
    assert rec["path"] in smoke.DEVICE_PATHS


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dna", "period1000", "words",
                                    "random_doubling"])
def test_gpu_family(smoke, pool, family):
    n = MiB if family == "random_doubling" else 16 * MiB
    rec = smoke.phase_family(family, *_corpus(smoke, pool, family, n))
    assert rec["path"] in smoke.FAMILIES[family][0]


@pytest.mark.gpu
def test_gpu_standalone_lcp(smoke, pool):
    smoke.phase_lcp(*_corpus(smoke, pool, "random", 16 * MiB))
