"""The port's logfmt logger (reference libs/log/tm_logger.go), on the
CPU: the ports of ``tests/test_log.py``'s seven cases, and each record
written by the port and by the JAX module from the same call is the
same line but for its timestamp."""

import io

import pytest

from cometbft_tpu.utils import log as JL
from cometbft_tpu_torch.utils import log as L


@pytest.fixture(autouse=True)
def _reset_levels():
    yield
    L.set_level("*:info")
    L.set_writer(None)  # sys.stderr at write time, the port's default


def _capture():
    buf = io.StringIO()
    L.set_writer(buf)
    return buf


def test_logfmt_line_shape():
    buf = _capture()
    lg = L.get_logger("consensus")
    lg.info("entering new round", height=5, round=0)
    line = buf.getvalue().strip()
    assert "level=info" in line
    assert "module=consensus" in line
    assert 'msg="entering new round"' in line
    assert "height=5" in line and "round=0" in line
    assert line.startswith("ts=")


def test_quoting_and_bytes():
    buf = _capture()
    lg = L.get_logger("test")
    lg.info('msg with "quotes"', h=b"\xde\xad", flag=True, f=0.5)
    line = buf.getvalue()
    assert "h=dead" in line
    assert "flag=true" in line
    assert "f=0.5" in line
    assert '\\"quotes\\"' in line


def test_lazy_values_not_rendered_below_level():
    buf = _capture()
    calls = []

    def expensive():
        calls.append(1)
        return "deadbeef"

    lg = L.get_logger("lazymod")
    lg.debug("hidden", h=L.Lazy(expensive))  # below info: not rendered
    assert calls == []
    L.set_level("lazymod:debug")
    lg.debug("shown", h=L.Lazy(expensive))
    assert calls == [1]
    assert "h=deadbeef" in buf.getvalue()


def test_module_scoped_levels():
    buf = _capture()
    L.set_level("consensus:debug,p2p:error,*:info")
    L.get_logger("consensus").debug("a")
    L.get_logger("p2p").info("b")  # suppressed
    L.get_logger("other").info("c")
    out = buf.getvalue()
    assert 'msg=a' in out
    assert 'msg=b' not in out
    assert 'msg=c' in out


def test_bound_fields():
    buf = _capture()
    lg = L.get_logger("peer").with_fields(peer="abc123")
    lg.info("hello", n=1)
    assert "peer=abc123" in buf.getvalue()


def test_invalid_level_raises():
    with pytest.raises(ValueError):
        L.set_level("verbose")


def test_lazy_error_never_raises():
    buf = _capture()
    L.get_logger("x").info(
        "ok", v=L.Lazy(lambda: 1 / 0)
    )
    assert "lazy error" in buf.getvalue()


@pytest.mark.parametrize(
    "call",
    [
        lambda L: L.get_logger("consensus").info("entering new round", height=5, round=0),
        lambda L: L.get_logger("test").error('msg with "quotes"', h=b"\xde\xad", flag=True, f=0.5),
        lambda L: L.get_logger("peer").with_fields(peer="abc123").info("hello", n=1, s="a b"),
        lambda L: L.get_logger("x").info("lazy", v=L.Lazy(lambda: 1 / 0), w=L.Lazy(lambda: b"\x01" * 9)),
    ],
)
def test_records_equal_the_jax_modules(call):
    bufs = []
    for mod in (L, JL):
        buf = io.StringIO()
        mod.set_writer(buf)
        try:
            call(mod)
        finally:
            mod.set_writer(__import__("sys").stderr if mod is JL else None)
        bufs.append(buf.getvalue())
    port, jax = (b.split(" ", 1) for b in bufs)
    assert port[0].startswith("ts=") and jax[0].startswith("ts=")
    assert port[1] == jax[1]
