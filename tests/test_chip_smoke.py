"""Each phase of ``chip_smoke.py`` at a tiny size on the CPU: the same
entry points, comparisons and tolerances the card run uses, with the
megakernel in the Pallas interpreter."""

import json

import pytest

import chip_smoke


def test_phase_render_tiny():
    cmp = chip_smoke.phase_render(size=16, recursion=3, passes=1,
                                  interpret=True)
    assert cmp["samepick"] == 0 and cmp["close"] >= 0.999


def test_phase_train_tiny():
    rel, loss_rel = chip_smoke.phase_train(size=16, recursion=3, steps=2)
    assert rel <= 1e-3 and loss_rel <= 1e-4


def test_phase_bvh_tiny():
    worst = chip_smoke.phase_bvh(grid=2, subdiv=1, size=16, recursion=2,
                                 passes=1, n_check=256, chunk=64)
    assert set(worst) == {"primary", "bounce"}
    assert worst["primary"][2] > 0  # some rays hit the mesh


@pytest.mark.parametrize("route", ["xla", "triton"])
def test_phase_four_cards_tiny(monkeypatch, route):
    """On 4 of the 8 virtual CPU devices; with the route forced to
    "triton" the recorders run the megakernel (interpreted) per device."""
    if route == "triton":
        from raytracercore import config
        from raytracercore.render import fused

        real = fused.trace_fused
        monkeypatch.setattr(config, "trace_route",
                            lambda scene, dtype: "triton")
        monkeypatch.setattr(fused, "trace_fused", lambda *a, **k: real(
            *a, **dict(k, interpret=True)))
    lines = chip_smoke.phase_four_cards(size=16, recursion=3)
    assert len(lines) == 4
    assert all("spans 4 devices" in line for line in lines
               if "render" in line)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert "ok" not in out
    for line in out.splitlines():
        assert not line.startswith("{")
    json.dumps({})  # the verdict is JSON; none was printed here


def test_capture_grads_keeps_params():
    import jax.numpy as jnp
    import optax

    cap = chip_smoke.capture_grads()
    params = {"a": jnp.ones(3)}
    grads = {"a": jnp.array([1.0, -2.0, 3.0])}
    updates, state = cap.update(grads, cap.init(params), params)
    assert float(jnp.abs(optax.apply_updates(params, updates)["a"]
                         - params["a"]).max()) == 0
    assert float(jnp.abs(state["a"] - grads["a"]).max()) == 0
