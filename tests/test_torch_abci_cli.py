"""The port's abci-cli client (reference abci/cmd/abci-cli), on the
CPU: the ports of ``tests/test_abci_cli.py``'s four cases (argument
parsing, a batch script, the console and one-shot errors over one
socket connection to a port kvstore server), and the same batch script
printing the same lines through the JAX package's ``AbciCli`` against
the same kind of server."""

import asyncio
import io
import threading

import pytest

from cometbft_tpu.cmd.abci_cli import AbciCli as JAbciCli
from cometbft_tpu_torch.cmd.abci_cli import AbciCli, string_or_hex_to_bytes
from cometbft_tpu_torch.models.kvstore import KVStoreApplication
from torch_hard_limit import hard_limit  # noqa: F401


def test_string_or_hex_to_bytes():
    assert string_or_hex_to_bytes("0x00ff") == b"\x00\xff"
    assert string_or_hex_to_bytes("0XAB") == b"\xab"
    assert string_or_hex_to_bytes('"a=1"') == b"a=1"
    with pytest.raises(ValueError, match="quoted"):
        string_or_hex_to_bytes("bare")
    with pytest.raises(ValueError, match="hex"):
        string_or_hex_to_bytes("0xzz")


@pytest.fixture()
def socket_app():
    """A port kvstore app behind the port's socket ABCI server, in a
    background event loop; yields the dial address."""
    from cometbft_tpu_torch.abci.server import ABCIServer

    app = KVStoreApplication()
    server = ABCIServer(app, "tcp://127.0.0.1:0")
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()
        await asyncio.Event().wait()

    t = threading.Thread(
        target=lambda: loop.run_until_complete(run()), daemon=True
    )
    t.start()
    assert started.wait(10)
    yield server.listen_addr
    loop.call_soon_threadsafe(loop.stop)


def test_batch_script_over_socket(socket_app):
    from cometbft_tpu_torch.abci.socket_client import SocketClient

    client = SocketClient(socket_app)
    out = io.StringIO()
    cli = AbciCli(client, out=out)
    script = io.StringIO(
        "# kvstore batch (reference example.file shape)\n"
        'check_tx "a=1"\n'
        'finalize_block "a=1" "b=2"\n'
        "commit\n"
        'query "a"\n'
        "info\n"
    )
    cli.batch(script)
    client.close()
    text = out.getvalue()
    assert text.count("-> code: OK") >= 4
    assert "-> value: 0x31" in text  # query "a" -> "1"
    # info after commit reports the app hash (height stays whatever the
    # finalize request carried — the reference CLI sends none either)
    assert "last_block_app_hash: 0x" in text


def test_console_runs_commands_and_exits(socket_app):
    from cometbft_tpu_torch.abci.socket_client import SocketClient

    client = SocketClient(socket_app)
    out = io.StringIO()
    cli = AbciCli(client, out=out)
    cli.console(io.StringIO("echo hello\nbogus_cmd\nexit\n"))
    client.close()
    text = out.getvalue()
    assert "-> data: hello" in text
    assert "unknown command" in text


def test_one_shot_error_paths(socket_app):
    from cometbft_tpu_torch.abci.socket_client import SocketClient

    client = SocketClient(socket_app)
    out = io.StringIO()
    cli = AbciCli(client, out=out)
    cli.run_line("check_tx bare-arg")  # unquoted -> error, not a crash
    assert "error" in out.getvalue()
    cli.run_line('check_tx "junk-no-equals"')
    assert "-> code: 1" in out.getvalue()  # kvstore rejects bad format
    client.close()


SCRIPT = (
    'check_tx "a=1"\n'
    'finalize_block "a=1" "b=2"\n'
    "commit\n"
    'query "a"\n'
    "echo hi\n"
)


def test_batch_prints_what_the_jax_cli_prints(socket_app):
    """The JAX AbciCli over a JAX SocketClient to a second port server
    prints the port CLI's lines for the same script (the app hash in the
    info line included)."""
    from cometbft_tpu.abci.socket_client import SocketClient as JSocketClient
    from cometbft_tpu_torch.abci.server import ABCIServer
    from cometbft_tpu_torch.abci.socket_client import SocketClient

    outs = []
    for cli_cls, client_cls in ((AbciCli, SocketClient), (JAbciCli, JSocketClient)):
        server = ABCIServer(KVStoreApplication(), "tcp://127.0.0.1:0")
        loop = asyncio.new_event_loop()
        started = threading.Event()

        async def run(server=server, started=started):
            await server.start()
            started.set()
            await asyncio.Event().wait()

        threading.Thread(target=lambda loop=loop, run=run: loop.run_until_complete(run()), daemon=True).start()
        assert started.wait(10)
        client = client_cls(server.listen_addr)
        out = io.StringIO()
        cli_cls(client, out=out).batch(io.StringIO(SCRIPT + "info\n"))
        client.close()
        loop.call_soon_threadsafe(loop.stop)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "-> value: 0x31" in outs[0] and "-> data: hi" in outs[0]
