"""Unix-domain-socket prover/verifier daemon on PyTorch and CUDA.

    python -m dusk_blindbidproof_tpu_torch.server --bind-path /tmp/bb.sock

The protocol of the original daemon: one TLV request frame per connection
turn; payload[0] is the opcode, 1 = prove, 2 = verify; a failed verification
answers the normal frame 0x00; an unknown opcode or a request that does not
parse answers the error frame 0xff and the daemon carries on.

Concurrency becomes the device's batch dimension: requests of one circuit
shape that arrive within the batching window are proven or verified in one
device pass, at whatever batch size arrived (1 to `max_batch`).

Device and start-up.  The device is resolved once, when the server starts:
CUDA unless `--device` (or `device=`) names another.  On CUDA the kernels are
built and the generator tables and the list-length-4 circuit are made before
the socket is bound, so a machine without a GPU, or a failing nvcc build,
ends the process with that error instead of a daemon that answers 0xff to
everybody.  Every device pass runs on the service's one worker thread, one
after another: the build, the launch counts, the profiling spans and the
cached tables are then touched by that thread alone, and it starts with the
resolved device as its current device.

Errors.  Every failure of a request answers the error frame and the daemon
serves on, as the JAX server does: bad bytes, a bad opcode, a `BlindBidError`,
a `ProofError` (a malformed proof, a bid list too long for the generator
capacity), a `ValueError` or an `AssertionError`, and also a plain
`RuntimeError` such as a torch shape check (a bug of the port, logged with
its traceback).  Only the device's own faults stop the server, after their
requests have had the error frame: `fused.KernelError` (the kernels failed to
build, to initialise or to launch), `torch.AcceleratorError` (a CUDA error
raised by torch) and `torch.OutOfMemoryError`.  Such a fault is kept in
`BlindBidServer.fault`, and `serve_forever` raises it.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import logging
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from .errors import BlindBidError, TlvError, wrap_exception
from .models import blindbid
from .models.bid import Bid
from .models.blindbid import ProveRequest, VerifyRequest
from .models.bulletproofs import generator_tables, resolve_device
from .models.constants import GENS_CAPACITY
from .models.proof_struct import BlindBidProof, R1CSProof
from .models.transcript_protocol import ProofError
from .ops import fused
from .utils.curve_host import L
from .utils.tlv import TlvReader, TlvWriter

log = logging.getLogger("blindbid.server")

OP_PROVE = 1
OP_VERIFY = 2
ERROR_FRAME = b"\xff"  # the error marker's payload
LIST_LEN = 4  # the bid-list length whose circuit is made at start-up


def _is_device_fault(exc: BaseException) -> bool:
    """True for a failure of the device or of the kernels' build, after which
    no later pass can be trusted; false for everything a request can cause."""
    return isinstance(exc, (fused.KernelError, torch.AcceleratorError,
                            torch.OutOfMemoryError))


def _read_scalars(r: TlvReader, names) -> list[int]:
    vals = []
    for name in names:
        v = int.from_bytes(r.read_scalar_bytes(), "little")
        if v >= L:
            raise TlvError(f"non-canonical scalar {name}")
        vals.append(v)
    return vals


def parse_prove_request(payload: bytes) -> ProveRequest:
    """Decode an opcode-1 body: seven canonical scalars, the bid list
    (from_bits entries, see models.bid) and the toggle position."""
    r = TlvReader(payload)
    scalars = _read_scalars(r, ("d", "k", "y", "y_inv", "q", "z_img", "seed"))
    pub_list = [b.x for b in Bid.try_list_from_reader(r)]
    toggle = r.read_u64()
    return ProveRequest(*scalars, pub_list=pub_list, toggle=toggle)


def encode_proof(proof: BlindBidProof) -> bytes:
    """TLV(r1cs bytes) ++ TLV-list(commitments) ++ TLV-list(toggle
    commitments)."""
    w = TlvWriter()
    w.write(proof.r1cs.to_bytes())
    w.write_list(proof.commitments)
    w.write_list(proof.t_c)
    return w.getvalue()


def decode_proof(data: bytes) -> BlindBidProof:
    r = TlvReader(data)
    r1cs = R1CSProof.from_bytes(r.expect_frame("r1cs proof"))
    commitments = r.read_list()
    t_c = r.read_list()
    for c in commitments + t_c:
        if len(c) != 32:
            raise ValueError("compressed points must be 32 bytes")
    return BlindBidProof(r1cs=r1cs, commitments=commitments, t_c=t_c)


def parse_verify_request(payload: bytes) -> VerifyRequest:
    """Decode an opcode-2 body: the proof frame, three canonical scalars and
    the bid list."""
    r = TlvReader(payload)
    proof = decode_proof(r.expect_frame("proof"))
    vals = _read_scalars(r, ("score", "z_img", "seed"))
    pub_list = [b.x for b in Bid.try_list_from_reader(r)]
    return VerifyRequest(proof, *vals, pub_list=pub_list)


def _warm_up(device: torch.device) -> None:
    """Everything a first request would otherwise build: the kernel library,
    the generator tables and the circuit of the usual list length."""
    fused.build()
    generator_tables(GENS_CAPACITY, device)
    blindbid.blindbid_circuit(LIST_LEN, device)


class BatchingService:
    """Groups concurrent same-shape requests into single device passes.

    A batch is flushed `window_ms` after its first request, or at once when
    it holds `max_batch` requests, so more than `max_batch` at a time split.
    All of its methods but `start` and `close` run on the event loop; the
    passes run on one worker thread."""

    def __init__(self, window_ms: float = 5.0, max_batch: int = 16, device=None):
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.device = device
        self._queues: dict = {}
        self._tasks: set = set()
        self._executor: ThreadPoolExecutor | None = None

    def start(self) -> None:
        """Resolve the device (raises without a GPU unless another device was
        named), start the worker thread and, on CUDA, warm it up."""
        self.device = resolve_device(self.device)
        on_cuda = self.device.type == "cuda"
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="blindbid-device",
            # a new thread's current device is cuda:0, whatever was resolved
            initializer=torch.cuda.set_device if on_cuda else None,
            initargs=(self.device,) if on_cuda else (),
        )
        if on_cuda:
            try:
                self._executor.submit(_warm_up, self.device).result()
            except BaseException:
                self.close()
                raise

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
            self._executor = None

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)  # the loop holds tasks weakly
        task.add_done_callback(self._tasks.discard)

    async def submit(self, kind: str, shape_key, item):
        """Returns the per-item result once its batch is flushed."""
        if self._executor is None:
            raise RuntimeError("BatchingService.start() has not run")
        fut = asyncio.get_running_loop().create_future()
        key = (kind, shape_key)
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = []
            self._spawn(self._flush_later(key, q))
        q.append((item, fut))
        if len(q) >= self.max_batch:
            del self._queues[key]
            self._spawn(self._flush(kind, q))
        return await fut

    async def _flush_later(self, key, q) -> None:
        await asyncio.sleep(self.window)
        if self._queues.get(key) is q:  # not flushed full in the meantime
            del self._queues[key]
            await self._flush(key[0], q)

    async def _flush(self, kind: str, q) -> None:
        items = [item for item, _ in q]
        run = blindbid.prove_batch if kind == "prove" else blindbid.verify_batch
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                self._executor, functools.partial(run, items, device=self.device)
            )
        except Exception as exc:  # every waiter of the batch learns of it
            for _, fut in q:
                if not fut.done():
                    fut.set_exception(exc)
            return
        for (_, fut), res in zip(q, results):
            if not fut.done():
                fut.set_result(res)


class BlindBidServer:
    def __init__(self, bind_path: str, service: BatchingService | None = None):
        self.bind_path = bind_path
        self.service = service or BatchingService()
        self.fault: BaseException | None = None  # what stopped the server, if a fault did
        self._stop = asyncio.Event()
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self.service.start()  # before the socket: no device, no daemon
        if os.path.exists(self.bind_path):
            os.unlink(self.bind_path)
        self._server = await asyncio.start_unix_server(self._handle, path=self.bind_path)
        log.info("listening on %s (device %s)", self.bind_path, self.service.device)

    def stop(self) -> None:
        """Make `serve_forever` return (call it on the server's loop)."""
        self._stop.set()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
            if os.path.exists(self.bind_path):
                os.unlink(self.bind_path)
        self.service.close()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            while True:
                request = await self._read_frame(reader)
                if request is None:
                    break
                response = await self._dispatch(request)
                writer.write(response)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except TlvError as exc:  # no frame boundary left to answer at
            log.error("closing a connection: %s", exc)
        finally:
            writer.close()

    async def _read_frame(self, reader: asyncio.StreamReader) -> bytes | None:
        # varint length prefix
        shift = 0
        n = 0
        while True:
            try:
                b = await reader.readexactly(1)
            except asyncio.IncompleteReadError:
                return None
            n |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                break
            shift += 7
            if shift > 63:
                raise TlvError("varint too long")
        return await reader.readexactly(n)

    async def _dispatch(self, request: bytes) -> bytes:
        w = TlvWriter()
        try:
            if not request:
                raise ValueError("empty request")
            opcode = request[0]
            body = request[1:]
            if opcode == OP_PROVE:
                req = parse_prove_request(body)
                proof = await self.service.submit("prove", len(req.pub_list), req)
                w.write(encode_proof(proof))
            elif opcode == OP_VERIFY:
                req = parse_verify_request(body)
                ok = await self.service.submit(
                    "verify", (len(req.pub_list), len(req.proof.r1cs.ipp_L)), req
                )
                # a failed verification is the normal answer 0x00, not an error
                w.write(b"\x01" if ok else b"\x00")
            else:
                raise ValueError(f"unknown opcode {opcode}")
        except Exception as exc:
            # one error domain (errors.py): any failure of a request answers
            # the error frame and the daemon lives on, unless it was the
            # device's own fault
            fault = _is_device_fault(exc)
            if fault:
                log.critical("device fault, stopping the server", exc_info=exc)
                if self.fault is None:
                    self.fault = exc
                self.stop()
            err = wrap_exception(exc)
            # neither the device's nor of the error domain: a bug of the
            # port, kept in the log with its traceback
            bug = not fault and not isinstance(exc, (BlindBidError, ProofError, ValueError))
            log.error("error resolving the request: [%s] %s", type(err).__name__, err,
                      exc_info=exc if bug else None)
            w = TlvWriter()
            w.write(ERROR_FRAME)
        return w.getvalue()

    async def serve_forever(self) -> None:
        """Serve until `stop` is called or a device fault stops the server;
        the fault is raised."""
        await self.start()
        try:
            await self._stop.wait()
        finally:
            await self.close()
        if self.fault is not None:
            raise self.fault


def default_bind_path() -> str:
    return os.path.join(tempfile.gettempdir(), "dusk-uds-blindbid")


def main(argv=None):
    ap = argparse.ArgumentParser("dusk-blindbidproof-torch")
    ap.add_argument("-b", "--bind-path", default=default_bind_path(),
                    help="Bind path")
    ap.add_argument("-l", "--log-level", default="info",
                    choices=["error", "warn", "info", "debug", "trace"])
    ap.add_argument("--device", default=None,
                    help="torch device of the passes (default: cuda; without a GPU "
                         "the server exits unless this names another device)")
    args = ap.parse_args(argv)
    level = {"error": logging.ERROR, "warn": logging.WARNING,
             "info": logging.INFO, "debug": logging.DEBUG,
             "trace": logging.DEBUG}[args.log_level]
    logging.basicConfig(level=level)
    server = BlindBidServer(args.bind_path, BatchingService(device=args.device))
    asyncio.run(server.serve_forever())


if __name__ == "__main__":
    main()
