"""A deterministic in-process stand-in for the part of ROS2 that the
simulator's node graph uses: the modules `rclpy`, `rclpy.node`,
`geometry_msgs.msg`, `std_msgs.msg` and `sensor_msgs.msg`, with the
fields the nodes touch.
Test code, not a feature of the port: the tests and `chip_smoke.py` phase
`ros2` run the JAX package's nodes and the port's under it. Not a test
module.

Semantics (rclpy's single-threaded executor, without DDS):
- one virtual clock; each timer fires at its period (the first time one
  period after it was made), timers due at the same time in the order
  they were made;
- a publication is delivered later, never inside `publish`: messages are
  delivered FIFO, each to every subscription of its topic in the order
  the subscriptions were made (each subscriber gets its own copy), and
  every pending message is delivered before the next timer fires;
- `spin(node)` drives every node made since `init` (all processes of a
  launch share the stand-in), until a callback raises SystemExit (it
  propagates out of `spin`; pending messages are dropped, as the launch
  kills the other processes) or `tick_limit` timer firings have run;
- `init` may be called again while the context is open (each node process
  of a launch joins the one context) and the context closes when the last
  `shutdown` balances the first `init`;
- message fields check their types as rclpy's generated setters do (a
  float64 field takes a float, an integer field an int), `publish` checks
  the message type, and a subscription must name the topic's type.
"""
from __future__ import annotations

import array
import copy
import sys
import time
import types
from dataclasses import dataclass

import pytest

MODULES = ("rclpy", "rclpy.node", "geometry_msgs", "geometry_msgs.msg",
           "std_msgs", "std_msgs.msg", "sensor_msgs", "sensor_msgs.msg")


# ------------------------------------------------------------- messages

class _Msg:
    """A message with typed fields: `_fields` {name: (kind, default)};
    kind float, int, str, bytes (uint8[]), list (float64[]/T[]) or a
    message class."""

    _fields: dict = {}

    def __init__(self, **kw):
        for name, (kind, default) in self._fields.items():
            object.__setattr__(self, name, default())
        for k, v in kw.items():
            setattr(self, k, v)

    def __setattr__(self, name, value):
        if name not in self._fields:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        kind = self._fields[name][0]
        if kind is float:
            ok = isinstance(value, float)
        elif kind is int:
            ok = isinstance(value, int) and not isinstance(value, bool)
        elif kind is str:
            ok = isinstance(value, str)
        elif kind is bytes:
            if isinstance(value, (bytes, bytearray, memoryview)):
                value = array.array("B", bytes(value))
            ok = isinstance(value, array.array) and value.typecode == "B"
        elif kind is list:
            ok = isinstance(value, list)
        else:
            ok = isinstance(value, kind)
        if not ok:
            raise AssertionError(
                f"The '{name}' field of {type(self).__name__} must be of "
                f"type {getattr(kind, '__name__', kind)}, not "
                f"{type(value).__name__}")
        object.__setattr__(self, name, value)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n in self._fields)

    def __repr__(self):
        return f"{type(self).__name__}(" + ", ".join(
            f"{n}={getattr(self, n)!r}" for n in self._fields) + ")"


def _msg(name, **fields):
    return type(name, (_Msg,), {"_fields": fields})


def _f(default=0.0):
    return (float, lambda: default)


Time = _msg("Time", sec=(int, int), nanosec=(int, int))
Header = _msg("Header", stamp=(Time, Time), frame_id=(str, str))
Point = _msg("Point", x=_f(), y=_f(), z=_f())
Vector3 = _msg("Vector3", x=_f(), y=_f(), z=_f())
Quaternion = _msg("Quaternion", x=_f(), y=_f(), z=_f(), w=_f(1.0))
Pose = _msg("Pose", position=(Point, Point),
            orientation=(Quaternion, Quaternion))
PoseWithCovariance = _msg("PoseWithCovariance", pose=(Pose, Pose),
                          covariance=(list, lambda: [0.0] * 36))
PoseWithCovarianceStamped = _msg(
    "PoseWithCovarianceStamped", header=(Header, Header),
    pose=(PoseWithCovariance, PoseWithCovariance))
PoseArray = _msg("PoseArray", header=(Header, Header), poses=(list, list))
Twist = _msg("Twist", linear=(Vector3, Vector3), angular=(Vector3, Vector3))
TwistStamped = _msg("TwistStamped", header=(Header, Header),
                    twist=(Twist, Twist))
Float64 = _msg("Float64", data=_f())
Image = _msg("Image", header=(Header, Header), height=(int, int),
             width=(int, int), encoding=(str, str), is_bigendian=(int, int),
             step=(int, int), data=(bytes, lambda: array.array("B")))

MESSAGES = {
    "std_msgs.msg": (Header, Float64),
    "geometry_msgs.msg": (Point, Vector3, Quaternion, Pose,
                          PoseWithCovariance, PoseWithCovarianceStamped,
                          PoseArray, Twist, TwistStamped),
    "sensor_msgs.msg": (Image,),
}


# ---------------------------------------------------------- the executor

@dataclass
class Publication:
    tick: int          # timer firings before it (0: before the first)
    node: str
    topic: str
    msg: object


class _Timer:
    def __init__(self, node, period, callback, order):
        self.node, self.period, self.callback = node, period, callback
        self.order, self.fired = order, 0

    @property
    def due(self):
        return (self.fired + 1) * self.period


class Ros2StandIn:
    """The stand-in's state and its modules. After a spin: `published`
    (every Publication), `logs` [(node, level, text)], `ticks` (timer
    firings), `ended_by` ("SystemExit", "tick limit" or "idle"),
    `tick_seconds` [host seconds of each firing with the deliveries it
    caused], `callback_seconds` {(node, topic or "timer"): [seconds]}."""

    def __init__(self, tick_limit=None):
        self.tick_limit = tick_limit
        self.inits = 0
        self.nodes, self.timers, self.subs = [], [], {}
        self.topic_types, self.queue = {}, []
        self.published, self.logs = [], []
        self.clock, self.ticks, self.ended_by = 0.0, 0, None
        self.tick_seconds, self.callback_seconds = [], {}
        self.modules = self._make_modules()
        self._saved = None

    # ---------------------------------------------------- the modules
    def _make_modules(self):
        standin = self
        mods = {name: types.ModuleType(name) for name in MODULES}
        for pkg, classes in MESSAGES.items():
            for cls in classes:
                setattr(mods[pkg], cls.__name__, cls)
            setattr(mods[pkg.split(".")[0]], "msg", mods[pkg])

        class Logger:
            def __init__(self, name):
                self.name = name

            def _log(self, level, text):
                standin.logs.append((self.name, level, str(text)))

            def info(self, text):
                self._log("info", text)

            def error(self, text):
                self._log("error", text)

        class Publisher:
            def __init__(self, node, msg_type, topic):
                self.node, self.msg_type, self.topic = node, msg_type, topic

            def publish(self, msg):
                if not isinstance(msg, self.msg_type):
                    raise TypeError(
                        f"{self.topic}: expected {self.msg_type.__name__}, "
                        f"got {type(msg).__name__}")
                msg = copy.deepcopy(msg)
                standin.queue.append((self.topic, msg))
                standin.published.append(Publication(
                    standin.ticks, self.node.get_name(), self.topic, msg))

        class Node:
            def __init__(self, node_name, **kwargs):
                if not standin.inits:
                    raise RuntimeError("rclpy.init() has not been called")
                self._name = node_name
                self._destroyed = False
                self._logger = Logger(node_name)
                standin.nodes.append(self)

            def get_name(self):
                return self._name

            def get_logger(self):
                return self._logger

            def create_publisher(self, msg_type, topic, qos_profile):
                standin._topic(topic, msg_type)
                return Publisher(self, msg_type, topic)

            def create_subscription(self, msg_type, topic, callback,
                                    qos_profile):
                standin._topic(topic, msg_type)
                sub = (self, callback)
                standin.subs.setdefault(topic, []).append(sub)
                return sub

            def create_timer(self, timer_period_sec, callback):
                if not timer_period_sec > 0:
                    raise ValueError("timer period must be positive")
                timer = _Timer(self, float(timer_period_sec), callback,
                               len(standin.timers))
                standin.timers.append(timer)
                return timer

            def destroy_node(self):
                self._destroyed = True
                standin.timers = [t for t in standin.timers
                                  if t.node is not self]
                for topic, subs in standin.subs.items():
                    standin.subs[topic] = [s for s in subs
                                           if s[0] is not self]
                return True

        def init(args=None, context=None):
            if not standin.inits:
                standin._open()
            standin.inits += 1

        def shutdown(context=None):
            if not standin.inits:
                raise RuntimeError("rclpy.shutdown() without init()")
            standin.inits -= 1

        def ok(context=None):
            return standin.inits > 0

        def spin(node, executor=None):
            if not standin.inits:
                raise RuntimeError("rclpy.init() has not been called")
            if node._destroyed:
                raise RuntimeError("spin() of a destroyed node")
            standin._spin()

        mods["rclpy.node"].Node = Node
        mods["rclpy"].node = mods["rclpy.node"]
        for fn in (init, shutdown, ok, spin):
            setattr(mods["rclpy"], fn.__name__, fn)
        return mods

    def _topic(self, topic, msg_type):
        known = self.topic_types.setdefault(topic, msg_type)
        if known is not msg_type:
            raise TypeError(f"topic {topic!r} carries {known.__name__}, "
                            f"not {msg_type.__name__}")

    def _open(self):
        self.nodes, self.timers, self.subs = [], [], {}
        self.topic_types, self.queue = {}, []
        self.published, self.logs = [], []
        self.clock, self.ticks, self.ended_by = 0.0, 0, None
        self.tick_seconds, self.callback_seconds = [], {}

    # ------------------------------------------------------ execution
    def _call(self, key, fn, arg=None):
        t0 = time.perf_counter()
        try:
            fn() if arg is None else fn(arg)
        finally:
            self.callback_seconds.setdefault(key, []).append(
                time.perf_counter() - t0)

    def _drain(self):
        while self.queue:
            topic, msg = self.queue.pop(0)
            for node, callback in list(self.subs.get(topic, ())):
                if not node._destroyed:
                    self._call((node.get_name(), topic), callback,
                               copy.deepcopy(msg))

    def _spin(self):
        try:
            self._drain()
            while True:
                if self.tick_limit is not None and \
                        self.ticks >= self.tick_limit:
                    self.ended_by = "tick limit"
                    return
                if not self.timers:
                    self.ended_by = "idle"
                    return
                timer = min(self.timers, key=lambda t: (t.due, t.order))
                self.clock = timer.due
                timer.fired += 1
                self.ticks += 1
                t0 = time.perf_counter()
                self._call((timer.node.get_name(), "timer"),
                           timer.callback)
                self._drain()
                self.tick_seconds.append(time.perf_counter() - t0)
        except SystemExit:
            self.ended_by = "SystemExit"
            self.queue.clear()
            raise

    # ------------------------------------------------- install, query
    def install(self):
        """Put the stand-in's modules into sys.modules (saving what held
        those names)."""
        self._saved = {name: sys.modules.get(name) for name in MODULES}
        sys.modules.update(self.modules)

    def uninstall(self):
        for name, mod in self._saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        self._saved = None

    def start(self, make_node, argv):
        """Build a node with `sys.argv = argv` (a node process's start),
        restoring sys.argv after; the context is opened if it is not."""
        if not self.inits:
            self.modules["rclpy"].init()
        saved = sys.argv
        sys.argv = list(argv)
        try:
            return make_node()
        finally:
            sys.argv = saved

    def run_main(self, main, argv):
        """Run a node process's `main()` with `sys.argv = argv`: it joins
        the open context and spins the whole graph."""
        saved = sys.argv
        sys.argv = list(argv)
        try:
            return main()
        finally:
            sys.argv = saved

    def on(self, topic):
        """The publications on `topic`, in order."""
        return [p for p in self.published if p.topic == topic]


@pytest.fixture
def ros2_standin():
    """A Ros2StandIn installed into sys.modules for one test; sys.argv and
    the modules it replaced are restored afterwards."""
    standin = Ros2StandIn()
    argv = sys.argv
    standin.install()
    try:
        yield standin
    finally:
        standin.uninstall()
        sys.argv = argv


# --------------------------------------------- a graph against the loop

def graph_record(standin):
    """What a graph run decided, in `loop_record`'s terms: the verdict
    (the evaluation node's last log line: info = success, error =
    collision; "timeout" when the tick limit ended the run), ticks (timer
    firings), frames (the simulator's objects or front_image
    publications) and the brakes applied [(tick index, brake)]: the
    control_cmd messages delivered before the run ended (one published in
    the last tick is dropped with the other pending messages)."""
    verdict = "timeout"
    if standin.ended_by == "SystemExit":
        level = [lvl for node, lvl, _ in standin.logs
                 if node == "evaluation"][-1]
        verdict = {"info": "success", "error": "collision"}[level]
    last = standin.ticks if standin.ended_by == "SystemExit" else None
    return dict(
        verdict=verdict, ticks=standin.ticks,
        frames=sum(p.node == "gaussian_rpg" and p.topic in (
            "objects", "front_image") for p in standin.published),
        brakes=[(p.tick - 1, p.msg.twist.linear.x)
                for p in standin.on("control_cmd") if p.tick != last])


def loop_record(result):
    """The same of a `run_closed_loop` result (tick index = log's tick)."""
    return dict(verdict=result.verdict, ticks=result.ticks,
                frames=result.frames_rendered,
                brakes=[(e["tick"], e["brake"]) for e in result.log
                        if e["brake"] != 0.0])


def stamp_time(ts: float) -> float:
    """A tape time as the evaluation node reads it back from the stamp the
    simulator node writes (sec = int(ts), nanosec = int((ts % 1) 1e9))."""
    return float(int(ts)) + 1e-9 * float(int((ts % 1.0) * 1e9))


def expected_graph(loop, tape, simulation_time):
    """The record the inline graph must show, given the loop's record on
    the same tape and parameters. The graph's evaluation node is built
    without a start time and checks the stamp on every cam_pose, before
    that tick's ground truth, where the loop's starts at the tape's first
    timestamp and checks at the imaging cadence: success comes on the
    first tick whose stamp is past the simulation time, and a collision
    the loop saw comes on the same tick unless that success is earlier.
    The simulator node renders the frame of the last tick before the
    evaluation sees it; the brakes are the loop's before that tick."""
    frames = tape["frames"]
    dt = 1.0 / float(tape.get("dynamic_freq", 50.0))
    sync = int(round(tape.get("dynamic_freq", 50)
                     / tape.get("image_freq", 10)))

    def ts(i):        # CarDynamics.tick's timestamp of tick index i
        if i < len(frames):
            return frames[i]["timestamp"]
        return frames[-1]["timestamp"] + (i - len(frames) + 1) * dt

    end = loop["ticks"] - 1
    verdict = loop["verdict"]
    first = next((i for i in range(end + 1)
                  if stamp_time(ts(i)) > simulation_time), None)
    if first is not None:
        verdict, end = "success", first
    elif verdict == "success":
        verdict = "timeout"
    return dict(verdict=verdict, ticks=end + 1, frames=end // sync + 1,
                brakes=[(i, b) for i, b in loop["brakes"] if i < end])
