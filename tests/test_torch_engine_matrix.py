"""Port parity: the engine feature matrix of the CLI (the JAX package's
tests/test_engine_matrix.py).

The wavefront engine covers the plain progressive path only; --orbit,
--tiles and --adaptive drive megakernel waves. Each unsupported
combination logs the JAX package's warning, word for word, and renders;
the supported combination warns of nothing. Run in-process with
``--device cpu``.
"""

import logging

import pytest
import torch

from pathtracing_tpu_torch import render
from pathtracing_tpu_torch.utils import logging as ptlog

torch.set_num_threads(2)

BASE = ["--device", "cpu", "--scene", "cornell_sphere", "--width", "16",
        "--height", "16", "--spp", "2", "--max-depth", "2",
        "--engine", "wavefront"]


@pytest.fixture
def warned():
    """Warnings the port logs while a test runs."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno == logging.WARNING:
                lines.append(record.getMessage())

    handler = Keep()
    ptlog.get_logger().addHandler(handler)
    yield lines
    ptlog.get_logger().removeHandler(handler)


def test_orbit_warns_and_falls_back(tmp_path, warned):
    assert render.main([*BASE, "--orbit", "2",
                        "--out", str(tmp_path / "f.png")]) == 0
    assert warned == ["--orbit always renders frames via the megakernel "
                      "engine; --engine wavefront is ignored for orbits"]
    assert (tmp_path / "f_0000.png").exists()
    assert (tmp_path / "f_0001.png").exists()


def test_tiles_warns_and_falls_back(tmp_path, warned):
    assert render.main([*BASE, "--tiles", "2",
                        "--out", str(tmp_path / "t.png")]) == 0
    assert warned == ["--tiles always renders via the megakernel engine; "
                      "--engine wavefront is ignored for tiled renders"]
    assert (tmp_path / "t.png").exists()


def test_adaptive_warns_and_falls_back(tmp_path, warned):
    assert render.main([*BASE, "--adaptive",
                        "--out", str(tmp_path / "a.png")]) == 0
    assert warned[0] == ("--adaptive renders band waves via the megakernel "
                         "engine; --engine wavefront is ignored")
    assert (tmp_path / "a.png").exists()


def test_plain_progressive_wavefront_no_warning(tmp_path, warned):
    assert render.main([*BASE, "--out", str(tmp_path / "p.png")]) == 0
    assert warned == []
    assert (tmp_path / "p.png").exists()
