"""A minimal hive for hermetic runs of the worker (the tests and
chip_smoke.py): stdlib HTTP on localhost, GET /api/work hands out queued
jobs, POST /api/results records envelopes. It also records what each poll
advertised and the auth header it carried.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeHive:
    def __init__(self, token: str = "test-token"):
        self.token = token
        self.jobs: list[dict] = []
        self.results: list[dict] = []
        self.polls: list[dict] = []
        self.auth_failures = 0
        self._cond = threading.Condition()
        hive = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _authorized(self) -> bool:
                if self.headers.get("Authorization") == f"Bearer {hive.token}":
                    return True
                with hive._cond:
                    hive.auth_failures += 1
                self._reply(400, {"message": "bad token"})
                return False

            def _reply(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path != "/api/work":
                    return self._reply(404, {"message": "not found"})
                if not self._authorized():
                    return
                params = dict(urllib.parse.parse_qsl(url.query))
                with hive._cond:
                    hive.polls.append(params)
                    jobs, hive.jobs = hive.jobs, []
                self._reply(200, {"jobs": jobs})

            def do_POST(self):
                if self.path != "/api/results":
                    return self._reply(404, {"message": "not found"})
                if not self._authorized():
                    return
                length = int(self.headers.get("Content-Length", 0))
                result = json.loads(self.rfile.read(length))
                with hive._cond:
                    hive.results.append(result)
                    hive._cond.notify_all()
                self._reply(200, {"ok": True, "id": result.get("id")})

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def enqueue(self, *jobs: dict) -> None:
        with self._cond:
            self.jobs.extend(jobs)

    def wait_for_results(self, n: int, timeout: float) -> list[dict]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self.results) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{len(self.results)} of {n} results after {timeout}s")
                self._cond.wait(left)
            return list(self.results)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
