"""The check sees `correct` come out false with the timed path broken
underneath (each fault a one-chip cell can have, faults.py), and with the
control (calibrate.py) in the program's place; a sound run is correct."""

import contextlib
import functools

import pytest
from helpers import CELLS, run_tiny, tiny_cell

import calibrate
import faults


@pytest.mark.parametrize("kind", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, kind):
    loop = tiny_cell(name).traffic["loop"]
    out = run_tiny(name, program=functools.partial(faults.planted, loop,
                                                   kind), seconds=0.5)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    out = run_tiny(name, program=calibrate.control)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_every_number_is_within_its_limit(name):
    out = run_tiny(name, seconds=0.5)
    assert out["correct"] is True
    for c in out["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"]


def test_a_fault_of_the_window_alone_is_not_correct():
    """A step that goes wrong only after set-up, as a path taken once warm
    would, passes the first steps' numbers and fails the window step's."""
    from harness import port
    inverse = port.module("grad.inverse")
    n = tiny_cell("cornell.fit").traffic["check_units"]

    @contextlib.contextmanager
    def late():
        real, calls = inverse.render, [0]

        def render(scene, camera, key, cfg):
            calls[0] += 1
            if calls[0] > n:
                key = faults._other_key(key)
            return real(scene, camera, key, cfg)
        inverse.render = render
        try:
            yield
        finally:
            inverse.render = real

    out = run_tiny("cornell.fit", program=late, seconds=0.5)
    checks = out["checks"]
    assert out["correct"] is False, checks
    for name in ("loss_gap", "grad_gap", "update_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], checks
    assert checks["window_loss_gap"]["value"] > checks[
        "window_loss_gap"]["limit"], checks
