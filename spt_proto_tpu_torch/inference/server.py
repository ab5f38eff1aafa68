"""HTTP serving front end over the continuous batching engine (port of
spt_proto_tpu/inference/server.py; stdlib only, as that file is, kept here
as the port's own copy so the port imports nothing of the JAX package).

One engine thread owns the step loop and is the only thread that touches
the device; request handler threads submit into it and block on a condition
variable until their completion lands. Endpoints:

  POST /v1/completions   {"prompt": [ids...] | "text", "max_tokens": N,
                          "stream": bool}
                         -> {"id", "tokens", "text"?, "n_tokens"}, or with
                            stream NDJSON lines {"tokens": [...]} then
                            {"done": true, "id", "n_tokens"}
  GET  /health           -> {"ok": true}
  GET  /stats            -> engine counters (active, queued, prefix hits,
                            speculative acceptance, completions served)

The engine is NOT thread-safe; every engine touch happens on the engine
thread (`_loop`). Handlers only enqueue (prompt, max_tokens) tuples and
wait. Batching across concurrent requests falls out of the engine's slot
scheduler: requests that arrive while a step is in flight are admitted at
the next step boundary.

Under a mesh (an engine built with mesh=, one process a rank) rank 0 owns
the HTTP socket and the frontend: before each step its engine thread
broadcasts the step's admissions (the (prompt, max_tokens) pairs it is
about to submit) to the other ranks, which run `follow`: submit the same
requests in the same order and step the same engine, so every rank's
scheduler takes the same decisions. An idle frontend broadcasts a no-step
message every HEARTBEAT_S seconds (the other ranks would otherwise wait
in the collective past its timeout), and shutdown broadcasts a stop.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

HEARTBEAT_S = 60.0


class ServingFrontend:
    """Thread-safe submit/wait facade over ContinuousBatchingEngine."""

    def __init__(self, engine, tokenizer=None):
        self.engine = engine
        self.mesh = getattr(engine, 'mesh', None)
        self.tokenizer = tokenizer
        self._cv = threading.Condition()
        self._pending: List[Tuple[int, List[int], int]] = []  # ticket,...
        self._tickets: Dict[int, Optional[List[int]]] = {}
        self._progress: Dict[int, List[int]] = {}   # ticket -> tokens so far
        self._errors: Dict[int, str] = {}           # ticket -> submit error
        self._rid_to_ticket: Dict[int, int] = {}
        self._next_ticket = 0
        self._stop = False
        self.n_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side ----------------------------------------------------
    def submit(self, prompt_tokens: List[int], max_tokens: int) -> int:
        with self._cv:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._tickets[ticket] = None
            self._pending.append((ticket, list(prompt_tokens), max_tokens))
            self._cv.notify_all()
            return ticket

    def wait(self, ticket: int, timeout: float = 300.0) -> List[int]:
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._tickets.get(ticket) is not None
                or ticket in self._errors or self._stop, timeout)
            if not ok:
                self._abandon(ticket)
                raise TimeoutError(f'ticket {ticket} timed out')
            if ticket in self._errors:
                raise ValueError(self._errors.pop(ticket))
            if self._stop and self._tickets.get(ticket) is None:
                raise RuntimeError('server shutting down')
            self._progress.pop(ticket, None)
            return self._tickets.pop(ticket)

    def _abandon(self, ticket: int) -> None:
        """Caller gave up on the ticket: drop all its state so the
        eventual completion (if any) is discarded by _loop instead of
        leaking for the life of the server. Must hold self._cv."""
        self._tickets.pop(ticket, None)
        self._progress.pop(ticket, None)
        self._errors.pop(ticket, None)

    def wait_progress(self, ticket: int, n_seen: int,
                      timeout: float = 300.0
                      ) -> Tuple[List[int], bool]:
        """Block until the ticket has MORE than `n_seen` tokens or is
        complete; returns (tokens so far, done). Streaming handlers call
        this in a loop, advancing n_seen past what they have sent."""
        with self._cv:
            def ready():
                if self._stop or self._tickets.get(ticket) is not None \
                        or ticket in self._errors:
                    return True
                return len(self._progress.get(ticket, ())) > n_seen
            if not self._cv.wait_for(ready, timeout):
                self._abandon(ticket)
                raise TimeoutError(f'ticket {ticket} timed out')
            if ticket in self._errors:
                raise ValueError(self._errors.pop(ticket))
            done = self._tickets.get(ticket) is not None
            if done:
                self._progress.pop(ticket, None)
                return self._tickets.pop(ticket), True
            if self._stop:
                raise RuntimeError('server shutting down')
            return list(self._progress[ticket]), False

    def stats(self) -> dict:
        eng = self.engine
        with self._cv:
            out = dict(active=eng.num_active, queued=eng.queue_depth,
                       pending=len(self._pending), served=self.n_served,
                       preemptions=eng.n_preemptions)
            if eng.prefix_on:
                out.update(prefix_hits=eng.prefix_hits,
                           prefix_tokens_reused=eng.prefix_tokens_reused)
            if eng.spec_k:
                s = eng.spec_stats
                out.update(spec_rounds=s['rounds'],
                           spec_acceptance=(s['accepted'] /
                                            max(1, s['proposed'])))
            return out

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    # -- engine thread ----------------------------------------------------
    def _loop(self) -> None:
        eng = self.engine
        while True:
            with self._cv:
                # sleep until there is work: a submission or live slots
                # (under a mesh, wake every HEARTBEAT_S to tell the other
                # ranks to wait on)
                self._cv.wait_for(
                    lambda: self._stop or self._pending
                    or eng.num_active or eng.queue_depth,
                    HEARTBEAT_S if self.mesh is not None else None)
                if self._stop:
                    if self.mesh is not None:
                        _tell(dict(stop=True))
                    return
                # abandoned tickets (client timed out) are not submitted
                batch = [(t, toks, mx) for t, toks, mx in self._pending
                         if t in self._tickets]
                self._pending.clear()
                if self.mesh is not None:
                    work = bool(batch or eng.num_active or eng.queue_depth)
                    _tell(dict(stop=False, step=work, reqs=[
                        (toks, mx) for _, toks, mx in batch]))
                    if not work:
                        continue
                for ticket, toks, mx in batch:
                    try:
                        rid = eng.submit(toks, max_new_tokens=mx)
                    except ValueError as e:
                        # oversized / unschedulable request: fail THIS
                        # ticket (surfaced as HTTP 400) and keep the
                        # engine thread alive for everyone else
                        self._errors[ticket] = str(e)
                        del self._tickets[ticket]
                        self._cv.notify_all()
                        continue
                    self._rid_to_ticket[rid] = ticket
                eng.step()
                changed = False
                for rid, toks in eng.live_progress().items():
                    t = self._rid_to_ticket.get(rid)
                    if t is not None and \
                            len(toks) > len(self._progress.get(t, ())):
                        self._progress[t] = toks
                        changed = True
                if eng.completions:
                    for c in eng.completions:
                        t = self._rid_to_ticket.pop(c.request_id, None)
                        if t is not None and t in self._tickets:
                            self._tickets[t] = c.tokens
                            self.n_served += 1
                        elif t is not None:
                            self._progress.pop(t, None)   # abandoned
                    eng.completions = []
                    changed = True
                if changed:
                    self._cv.notify_all()


def _tell(msg: dict) -> dict:
    """Rank 0's step message to every rank (a broadcast over the world)."""
    from spt_proto_tpu_torch.parallel import comm
    return comm.broadcast_object(msg, src=0)


def follow(engine) -> None:
    """The loop of a rank other than 0 under a mesh: take rank 0's step
    messages, submit the same requests (a request that rank 0's engine
    refuses is refused here too) and step the same engine, until rank 0
    stops."""
    while True:
        msg = _tell(None)
        if msg['stop']:
            return
        for toks, mx in msg['reqs']:
            try:
                engine.submit(toks, max_new_tokens=mx)
            except ValueError:
                pass
        if msg['step']:
            engine.step()
            engine.completions = []


class _Handler(BaseHTTPRequestHandler):
    frontend: ServingFrontend = None   # set by make_server

    def log_message(self, *a):          # quiet
        pass

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == '/health':
            self._json(200, {'ok': True})
        elif self.path == '/stats':
            self._json(200, self.frontend.stats())
        else:
            self._json(404, {'error': 'unknown path'})

    def do_POST(self):
        if self.path not in ('/v1/completions', '/completions'):
            self._json(404, {'error': 'unknown path'})
            return
        try:
            n = int(self.headers.get('Content-Length', 0))
            req = json.loads(self.rfile.read(n) or b'{}')
            prompt = req.get('prompt')
            fe = self.frontend
            if isinstance(prompt, str):
                if fe.tokenizer is None:
                    raise ValueError('text prompt needs a tokenizer; '
                                     'pass token ids')
                ids = fe.tokenizer.encode(prompt)
            elif isinstance(prompt, list):
                ids = [int(t) for t in prompt]
            else:
                raise ValueError('"prompt" must be a string or id list')
            mx = int(req.get('max_tokens', 32))
            if len(ids) + mx > fe.engine.max_len:
                raise ValueError('prompt + max_tokens exceeds engine '
                                 f'max_len ({fe.engine.max_len})')
            timeout = float(req.get('timeout', 300))
            ticket = fe.submit(ids, mx)
            if req.get('stream'):
                # NDJSON streaming: one {"tokens": [...]} line per decode
                # increment, then a final {"done": true} line
                self.send_response(200)
                self.send_header('Content-Type', 'application/x-ndjson')
                self.send_header('Connection', 'close')
                self.end_headers()
                seen = 0
                try:
                    while True:
                        toks, done = fe.wait_progress(ticket, seen, timeout)
                        if len(toks) > seen:
                            line = {'tokens': toks[seen:]}
                            if fe.tokenizer is not None:
                                line['text'] = \
                                    fe.tokenizer.decode(toks[seen:])
                            self.wfile.write(
                                json.dumps(line).encode() + b'\n')
                            self.wfile.flush()
                            seen = len(toks)
                        if done:
                            self.wfile.write(json.dumps(
                                {'done': True, 'id': ticket,
                                 'n_tokens': seen}).encode() + b'\n')
                            self.wfile.flush()
                            return
                except Exception as e:
                    # headers already sent: a second status line would
                    # corrupt the body — emit a terminal NDJSON error
                    # record instead and close the stream
                    try:
                        self.wfile.write(json.dumps(
                            {'error': str(e)}).encode() + b'\n')
                        self.wfile.flush()
                    except OSError:
                        pass
                    return
            toks = fe.wait(ticket, timeout=timeout)
            out = {'id': ticket, 'tokens': toks, 'n_tokens': len(toks)}
            if fe.tokenizer is not None:
                out['text'] = fe.tokenizer.decode(toks)
            self._json(200, out)
        except (ValueError, KeyError) as e:
            self._json(400, {'error': str(e)})
        except TimeoutError as e:
            self._json(504, {'error': str(e)})


def make_server(engine, host: str = '127.0.0.1', port: int = 0,
                tokenizer=None) -> Tuple[ThreadingHTTPServer,
                                         ServingFrontend]:
    """Build (but do not start) an HTTP server bound to host:port
    (port 0 = ephemeral). Caller runs server.serve_forever(); shut down
    with server.shutdown() then frontend.shutdown()."""
    frontend = ServingFrontend(engine, tokenizer=tokenizer)
    handler = type('Handler', (_Handler,), {'frontend': frontend})
    server = ThreadingHTTPServer((host, port), handler)
    return server, frontend
