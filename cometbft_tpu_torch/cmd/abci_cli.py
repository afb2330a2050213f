"""The abci-cli client (reference abci/cmd/abci-cli/abci-cli.go):
one-shot requests, an interactive ``console`` and a ``batch`` mode that
runs a piped script, all over one ABCI socket connection to a running
app server (the ``abci-server`` command, or any app that speaks the
codec).

A copy of the JAX package's ``cmd/abci_cli.py``. The command language
(reference cmdUnimplemented/muxOnCommands):

    echo <msg>
    info
    check_tx 0x00
    finalize_block 0x00 0x01 "some tx"
    prepare_proposal 0x01 ...
    process_proposal 0x01 ...
    commit
    query 0xabcd | "key"
"""

from __future__ import annotations

import shlex
import sys
from typing import List

from ..abci import types as abci


def string_or_hex_to_bytes(s: str) -> bytes:
    """Reference stringOrHexToBytes (abci-cli.go:764): 0x-prefixed hex
    or a "quoted" string — bare strings are rejected with guidance."""
    if s.lower().startswith("0x"):
        try:
            return bytes.fromhex(s[2:])
        except ValueError:
            raise ValueError(f"error decoding hex argument: {s}") from None
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1].encode()
    raise ValueError(
        f"invalid string arg: \"{s}\" must be quoted or a hex string"
    )


def _print_response(out, code=None, data=None, log=None, info=None, extra=()):
    if code is not None:
        out.write(f"-> code: {'OK' if code == 0 else code}\n")
    if log:
        out.write(f"-> log: {log}\n")
    if info:
        out.write(f"-> info: {info}\n")
    if data is not None and data != b"":
        try:
            out.write(f"-> data: {data.decode()}\n")
        except UnicodeDecodeError:
            pass
        out.write(f"-> data.hex: 0x{data.hex().upper()}\n")
    for k, v in extra:
        out.write(f"-> {k}: {v}\n")


class AbciCli:
    """Dispatches the command language against a connected client
    (SocketClient or the in-process LocalClient — same interface)."""

    def __init__(self, client, out=None):
        self.client = client
        self.out = out or sys.stdout

    def run_line(self, line: str) -> bool:
        """Execute one command line. Returns False on 'exit'/'quit'."""
        try:
            parts = shlex.split(line, posix=False)
        except ValueError as e:  # e.g. unbalanced quote — keep the REPL
            self.out.write(f"-> error: {e}\n")
            return True
        if not parts:
            return True
        cmd, args = parts[0], parts[1:]
        if cmd in ("exit", "quit"):
            return False
        fn = getattr(self, "do_" + cmd, None)
        if fn is None:
            self.out.write(
                f"-> error: unknown command {cmd!r} (try: echo info "
                "check_tx finalize_block prepare_proposal "
                "process_proposal commit query)\n"
            )
            return True
        try:
            fn(args)
        except Exception as e:
            self.out.write(f"-> error: {e}\n")
        return True

    # --- commands -----------------------------------------------------

    def do_echo(self, args: List[str]) -> None:
        msg = args[0] if args else ""
        got = self.client.echo(msg)
        _print_response(self.out, data=got.encode())

    def do_info(self, args: List[str]) -> None:
        r = self.client.info(abci.RequestInfo())
        _print_response(
            self.out,
            data=(r.data or "").encode(),
            extra=[
                ("version", r.version),
                ("last_block_height", r.last_block_height),
                ("last_block_app_hash", "0x" + r.last_block_app_hash.hex()),
            ],
        )

    def do_check_tx(self, args: List[str]) -> None:
        if len(args) != 1:
            raise ValueError("check_tx takes exactly one tx argument")
        r = self.client.check_tx(
            abci.RequestCheckTx(tx=string_or_hex_to_bytes(args[0]))
        )
        _print_response(self.out, code=r.code, log=r.log)

    def do_finalize_block(self, args: List[str]) -> None:
        txs = [string_or_hex_to_bytes(a) for a in args]
        r = self.client.finalize_block(abci.RequestFinalizeBlock(txs=txs))
        for txr in r.tx_results:
            _print_response(self.out, code=txr.code, log=txr.log)
        _print_response(
            self.out, extra=[("app_hash", "0x" + r.app_hash.hex())]
        )

    def do_prepare_proposal(self, args: List[str]) -> None:
        txs = [string_or_hex_to_bytes(a) for a in args]
        r = self.client.prepare_proposal(
            abci.RequestPrepareProposal(
                txs=txs, max_tx_bytes=10 * 1024 * 1024
            )
        )
        for tx in r.txs:
            _print_response(self.out, extra=[("tx", "0x" + tx.hex())])

    def do_process_proposal(self, args: List[str]) -> None:
        txs = [string_or_hex_to_bytes(a) for a in args]
        r = self.client.process_proposal(
            abci.RequestProcessProposal(txs=txs)
        )
        _print_response(
            self.out,
            extra=[("status", "ACCEPT" if r.is_accepted() else "REJECT")],
        )

    def do_commit(self, args: List[str]) -> None:
        self.client.commit()
        _print_response(self.out, code=0)

    def do_query(self, args: List[str]) -> None:
        if len(args) != 1:
            raise ValueError("query takes exactly one data argument")
        r = self.client.query(
            abci.RequestQuery(data=string_or_hex_to_bytes(args[0]))
        )
        _print_response(
            self.out,
            code=r.code,
            log=r.log,
            extra=[
                ("height", r.height),
                ("key", "0x" + r.key.hex() if r.key else ""),
                ("value", "0x" + r.value.hex() if r.value else ""),
            ],
        )

    # --- modes --------------------------------------------------------

    def console(self, in_stream=None) -> None:
        """Interactive REPL (reference consoleCmd): one connection for
        many commands."""
        in_stream = in_stream or sys.stdin
        while True:
            self.out.write("> ")
            self.out.flush()
            line = in_stream.readline()
            if not line:
                break
            if not self.run_line(line.strip()):
                break

    def batch(self, in_stream=None) -> None:
        """Piped script mode (reference batchCmd)."""
        in_stream = in_stream or sys.stdin
        for line in in_stream:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            self.out.write(f"> {line}\n")
            self.run_line(line)


def run_abci_cli(address: str, command: str, args: List[str],
                 out=None) -> int:
    """Entry for the ``abci-cli`` subcommand: connect, run, disconnect."""
    from ..abci.socket_client import SocketClient

    client = SocketClient(address)
    cli = AbciCli(client, out=out)
    try:
        if command == "console":
            cli.console()
        elif command == "batch":
            cli.batch()
        else:
            if not cli.run_line(
                " ".join([command] + list(args))
            ):
                return 0
    finally:
        client.close()
    return 0
