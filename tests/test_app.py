"""Platform/application layer tests (SURVEY L0).

Covers the event-queue semantics of `keyboard.{h,cu}`/`mouse.{h,cu}` (16-deep
FIFO with oldest-dropped trim, key bitset, wheel-delta accumulation), the
window message routing of `window.cu:105-201` (autorepeat suppression,
enter/leave with held-button exception, killfocus clearing), the timer, and
the application loop of `application.cu:66-113` (P-key engine toggle at the
frame boundary, right-button accumulation reset, FPS title format).
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from ptre.app.events import (
    NUM_EVENTS,
    Keyboard,
    KeyEventType,
    Mouse,
    MouseButton,
    MouseEventType,
)
from ptre.app.timer import Timer
from ptre.app.window import (
    MSG_BUTTON_DOWN,
    MSG_BUTTON_UP,
    MSG_CLOSE,
    MSG_KEY_DOWN,
    MSG_KEY_UP,
    MSG_KILLFOCUS,
    MSG_MOUSE_MOVE,
    MSG_WHEEL,
    Window,
    WindowError,
    ansi_presenter,
)


# ---------------------------------------------------------------- keyboard
def test_keyboard_press_release_and_state():
    kb = Keyboard()
    kb.on_key_pressed("P")
    assert kb.key_is_pressed("P") and not kb.key_is_pressed("Q")
    e = kb.get_event()
    assert e.type == KeyEventType.PRESS and e.key == ord("P")
    kb.on_key_released("P")
    assert not kb.key_is_pressed("P")
    assert kb.get_event().type == KeyEventType.RELEASE


def test_keyboard_empty_queue_yields_invalid():
    kb = Keyboard()
    assert not kb.get_event().valid
    assert not kb.peek_event().valid


def test_keyboard_queue_trims_oldest_beyond_16():
    kb = Keyboard()
    for i in range(NUM_EVENTS + 5):
        kb.on_key_pressed(i)
    assert len(kb) == NUM_EVENTS
    # oldest 5 dropped (`keyboard.cu:64-69`)
    assert kb.get_event().key == 5


def test_keyboard_peek_does_not_pop():
    kb = Keyboard()
    kb.on_key_pressed("A")
    assert kb.peek_event().key == ord("A")
    assert len(kb) == 1
    assert kb.get_event().key == ord("A")
    assert len(kb) == 0


# ------------------------------------------------------------------- mouse
def test_mouse_buttons_and_position():
    m = Mouse()
    m.on_button_pressed(MouseButton.RIGHT, 10, 20)
    assert m.button_is_pressed(MouseButton.RIGHT)
    assert not m.button_is_pressed(MouseButton.LEFT)
    e = m.get_event()
    assert e.type == MouseEventType.PRESS and e.position == (10, 20)
    m.on_button_released(MouseButton.RIGHT, 11, 21)
    assert not m.button_is_pressed(MouseButton.RIGHT)


def test_mouse_wheel_accumulates_to_notches():
    m = Mouse()
    # +300 = two WHEELUP notches, 60 left over (`mouse.cu:99-114`)
    m.on_wheel_rotated(300, 0, 0)
    assert m.get_event().type == MouseEventType.WHEELUP
    assert m.get_event().type == MouseEventType.WHEELUP
    assert not m.get_event().valid
    # +60 more crosses the threshold once
    m.on_wheel_rotated(60, 0, 0)
    assert m.get_event().type == MouseEventType.WHEELUP
    # negative deltas emit WHEELDOWN
    m.on_wheel_rotated(-240, 0, 0)
    assert m.get_event().type == MouseEventType.WHEELDOWN
    assert m.get_event().type == MouseEventType.WHEELDOWN


def test_mouse_queue_trims_oldest():
    m = Mouse()
    for i in range(NUM_EVENTS + 3):
        m.on_mouse_move(i, i)
    assert len(m) == NUM_EVENTS
    assert m.get_event().x == 3


# ------------------------------------------------------------------ window
def test_window_routes_key_messages_and_suppresses_autorepeat():
    w = Window(64, 64)
    w.inject(MSG_KEY_DOWN, "P")
    w.inject(MSG_KEY_DOWN, "P")  # autorepeat: must NOT enqueue a 2nd PRESS
    w.inject(MSG_KEY_UP, "P")
    assert w.process_messages()
    assert w.keyboard.get_event().type == KeyEventType.PRESS
    assert w.keyboard.get_event().type == KeyEventType.RELEASE
    assert not w.keyboard.get_event().valid


def test_window_killfocus_clears_key_states():
    w = Window(64, 64)
    w.inject(MSG_KEY_DOWN, "W")
    w.process_messages()
    assert w.keyboard.key_is_pressed("W")
    w.inject(MSG_KILLFOCUS)
    w.process_messages()
    assert not w.keyboard.key_is_pressed("W")


def test_window_mouse_enter_leave_semantics():
    w = Window(100, 100)
    w.inject(MSG_MOUSE_MOVE, 50, 50)
    w.process_messages()
    assert w.mouse.is_in_window()
    types = []
    while True:
        e = w.mouse.get_event()
        if not e.valid:
            break
        types.append(e.type)
    assert MouseEventType.ENTER in types
    # outside with no button held -> leave
    w.inject(MSG_MOUSE_MOVE, 500, 500)
    w.process_messages()
    assert not w.mouse.is_in_window()
    # outside with a button held -> still tracked (capture semantics)
    w.inject(MSG_MOUSE_MOVE, 50, 50)
    w.inject(MSG_BUTTON_DOWN, int(MouseButton.LEFT), 50, 50)
    w.process_messages()
    w.inject(MSG_MOUSE_MOVE, 500, 500)
    w.process_messages()
    assert w.mouse.get_position() == (500, 500)
    w.inject(MSG_BUTTON_UP, int(MouseButton.LEFT), 500, 500)
    w.process_messages()


def test_window_close_ends_pump_and_wheel_routing():
    w = Window(64, 64)
    w.inject(MSG_WHEEL, 120, 5, 5)
    assert w.process_messages()
    assert w.mouse.get_event().type == MouseEventType.WHEELUP
    w.post_quit()
    assert not w.process_messages()


def test_window_rejects_bad_geometry_and_unknown_message():
    with pytest.raises(WindowError):
        Window(0, 10)
    w = Window(8, 8)
    w.inject("bogus")
    with pytest.raises(WindowError):
        w.process_messages()


def test_ansi_presenter_writes_truecolor_cells():
    buf = io.StringIO()
    w = Window(16, 8, presenter=ansi_presenter(stream=buf, max_cols=16))
    frame = np.zeros((8, 16, 3), np.uint8)
    frame[..., 0] = 255
    w.present(frame)
    out = buf.getvalue()
    assert "\x1b[38;2;255;0;0m" in out
    assert w.last_frame is frame


# ------------------------------------------------------------------- timer
def test_timer_delta_and_total_with_fake_clock():
    t = {"now": 100.0}
    tm = Timer(clock=lambda: t["now"])
    t["now"] = 100.25
    assert tm.get_delta() == pytest.approx(0.25)
    t["now"] = 100.75
    assert tm.get_delta() == pytest.approx(0.5)
    assert tm.get_total_time() == pytest.approx(0.75)


# ------------------------------------------------------------- application
@pytest.fixture()
def tiny_renderer():
    from ptre.models import demo
    from ptre.ops import camera as cam_ops
    from ptre.render.engine import Renderer
    from ptre.utils.config import RasterConfig, RenderConfig

    scene = demo.reference_demo_scene(8, 4)
    cam = cam_ops.Camera.create(width=16, height=12)
    return Renderer(
        scene,
        cam,
        RenderConfig(width=16, height=12),
        RasterConfig(width=16, height=12),
    )


def test_application_p_key_toggles_engine(tiny_renderer):
    from ptre.app.application import Application
    from ptre.render.engine import EngineKind

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    assert tiny_renderer.engine == EngineKind.PATHTRACER
    w.inject(MSG_KEY_DOWN, "P")
    assert app.run(max_frames=1) == 1
    assert tiny_renderer.engine == EngineKind.RASTERIZER
    # presented frame reached the window
    assert w.last_frame is not None and w.last_frame.shape == (12, 16, 3)
    # toggle back: one event is consumed per frame (`application.cu:78-85`),
    # so the RELEASE is read first and the PRESS lands on the next frame
    w.inject(MSG_KEY_UP, "P")
    w.inject(MSG_KEY_DOWN, "P")
    app.run(max_frames=2)
    assert tiny_renderer.engine == EngineKind.PATHTRACER


def test_application_right_button_resets_accumulation(tiny_renderer):
    from ptre.app.application import Application

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    app.run(max_frames=2)
    assert int(tiny_renderer.accum.frame) >= 2
    w.inject(MSG_BUTTON_DOWN, int(MouseButton.RIGHT), 1, 1)
    app.run(max_frames=1)
    # reset applied before the frame's sample -> counter restarted at 1
    assert int(tiny_renderer.accum.frame) == 1
    w.inject(MSG_BUTTON_UP, int(MouseButton.RIGHT), 1, 1)


def test_application_quit_message_stops_loop(tiny_renderer):
    from ptre.app.application import Application

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    w.post_quit()
    assert app.run(max_frames=10) == 0


def test_application_fps_title_format(tiny_renderer):
    from ptre.app.application import Application

    w = Window(16, 12)
    app = Application(window=w, renderer=tiny_renderer)
    t = {"now": 0.0}
    app.timer = Timer(clock=lambda: t["now"])
    for _ in range(4):
        t["now"] += 0.3
        app.run_frame()
    # 1.2s elapsed at the 4th frame -> title shows FPS: 4 (250.0ms)
    assert w.title == "FPS: 4 (250.0ms)"
