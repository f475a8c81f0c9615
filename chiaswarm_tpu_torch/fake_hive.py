"""A minimal hive for hermetic runs of the worker (the tests and
chip_smoke.py): stdlib HTTP on localhost, GET /api/work hands out queued
jobs, POST /api/results records envelopes. It also records what each poll
advertised and the auth header it carried. Files queued with
`enqueue_file` are served without auth under /files/<name> (HEAD answers
their Content-Type and Content-Length), so a job's `start_image_uri` and
`mask_image_uri` can point at them.

What the repo's hive (chiaswarm_tpu/hive_server) does for a chunked pass,
in small:

- a poll with `cancel_only=1` (the worker's heartbeat while its device is
  busy) is handed no job;
- `cancel(job_id)` revokes a job: the next reply carries it in `cancels`
  (once); `cancel_after_first_partial(job_id)` does so as soon as the
  job's first checkpoint or preview arrives, and `cancel_on_heartbeat(job_id,
  n)` on the n-th cancel-only poll from now, which let a caller cancel a
  pass in its middle;
- POST /api/jobs/{id}/checkpoint and /preview store the blob under its
  sha256 (served back by GET /api/artifacts/<sha256>) and record the
  partial; the newest checkpoint of a job is kept;
- `redeliver(job)` queues a job again as a redelivery: handed to a poller
  that advertised `resume_capable`, it carries the `resume` offer {href,
  step, signature} of the job's newest checkpoint; `put_checkpoint` plants
  one (a blob cut under another program signature, say).

And what the worker's outbox must survive:

- `refuse(job_id, status)`: POST /api/results for that job answers the 4xx
  `status` (a permanent refusal; the worker parks the envelope);
- `dispose(job_id, disposition)`: the POST is ACKed with the disposition
  ("cancelled", "expired" or "unknown_job") and the result is not stored
  (`disposed` records it; the worker parks the envelope);
- `drop_results_times`: that many POSTs to /api/results are read and their
  connection closed before any answer (a hive that died before its ACK);
- every stored POST's raw body is kept by job id (`bodies`), so a
  redelivery shows as a second body, and `duplicates` counts them.

What a worker meets among several hives, gangs and stage graphs:

- `not_primary(epoch, endpoints, message)`: /work and /results (or those
  named) answer 409 "not primary" with `X-Hive-Epoch`, as a standby or a
  deposed primary does; `promote(epoch)` serves again. Every answer carries
  `X-Hive-Epoch` once `epoch` is above 0; `requests` records each request
  (time.monotonic(), path, the epoch it echoed or None), `handed` and
  `settled` when a reply handed each job and when its result was stored;
- `go_dark()`: every request's connection is closed before any answer (a
  hive that died);
- `enqueue_gang(*jobs)`: the jobs leave in one reply, each with the
  `trace` context a gang-scheduling hive stamps ({id, attempt, gang: {id,
  size, index}}); `polls` keeps every poll's parameters (`gang_rows`,
  `stages`, `stats` among them);
- `submit_workflow(payload, workflow_id)`: a txt2img submission expanded
  as the repo's hive expands it (chiaswarm_tpu/hive_server/dag.py
  `_expand_diffusion`): encode, denoise with the raw handoff, an upscale
  stage when `upscale` is set, decode; the same stage ids
  (`<workflow>-s<index>-<name>`), `stage` dicts and inheritance. A stage
  is handed only to a poller that advertises it in `stages`, once every
  stage it needs is done, with the predecessors' artifacts as `inputs`
  spool references ({sha256, bytes, href, content_type}) served under
  /api/artifacts/<sha256>. `workflow(workflow_id)` gives the stages'
  states and the final stage's envelope.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


# a standby's refusal, as the repo's hive words it
NOT_PRIMARY = "not primary: standby replicating (fail over to the promoted hive)"


class FakeHive:
    def __init__(self, token: str = "test-token"):
        self.token = token
        self.jobs: list[dict] = []
        self.results: list[dict] = []
        self.polls: list[dict] = []
        self.auth_failures = 0
        self.files: dict[str, tuple[bytes, str]] = {}
        # sha256 -> blob, for checkpoints and previews
        self.artifacts: dict[str, bytes] = {}
        # every checkpoint or preview POST, in arrival order
        self.partials: list[dict] = []
        # job id -> its newest checkpoint {step, sha256, signature, bytes}
        self.checkpoints: dict[str, dict] = {}
        # revocations for the next reply, and those armed on a first partial
        self.pending_cancels: list[str] = []
        self.cancel_on_partial: set[str] = set()
        # job id -> cancel-only polls still to come before its revocation
        self.cancel_on_polls: dict[str, int] = {}
        # job id -> time.monotonic() when a reply carried its cancel
        self.cancels_sent: dict[str, float] = {}
        # the ids queued as redeliveries
        self._redelivered: set[str] = set()
        # job id -> the 4xx status its result POST is answered with
        self.refusals: dict[str, int] = {}
        # job id -> the disposition its result POST is ACKed with
        self.dispositions: dict[str, str] = {}
        # results ACKed with a disposition, not stored
        self.disposed: list[dict] = []
        # result POSTs to cut before the answer, and every POST to /results
        self.drop_results_times = 0
        self.result_attempts = 0
        # job id -> the raw body of each stored result POST, in order
        self.bodies: dict[str, list[bytes]] = {}
        # the fencing epoch this hive advertises, the endpoints ("work",
        # "results") that refuse as not-primary, and the epochs requests echoed
        self.epoch = 0
        self.refusing: set[str] = set()
        self.refusal = NOT_PRIMARY
        self.requests: list[tuple[float, str, str | None]] = []
        # job id -> time.monotonic() when a reply handed it, and when its
        # result was stored
        self.handed: dict[str, float] = {}
        self.settled: dict[str, float] = {}
        # close every connection unanswered
        self.dark = False
        # workflow id -> {"stages": [...], "payload"}; stage job id -> (wf, index)
        self.workflows: dict[str, dict] = {}
        self._stage_of: dict[str, tuple[str, int]] = {}
        self._gangs = 0
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

            def _reply(self, status: int, payload: dict, with_body: bool = True) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if hive.epoch > 0:
                    self.send_header("X-Hive-Epoch", str(hive.epoch))
                self.end_headers()
                if with_body:
                    self.wfile.write(body)

            def _bytes(self, body: bytes, content_type: str, with_body: bool) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if with_body:
                    self.wfile.write(body)

            def _file(self, with_body: bool) -> bool:
                """Serve /files/<name>; False for any other path."""
                path = urllib.parse.urlparse(self.path).path
                if not path.startswith("/files/"):
                    return False
                with hive._cond:
                    found = hive.files.get(urllib.parse.unquote(path[len("/files/"):]))
                if found is None:
                    self._reply(404, {"message": "no such file"}, with_body)
                    return True
                self._bytes(*found, with_body)
                return True

            def do_HEAD(self):
                if not self._file(with_body=False):
                    self._reply(404, {"message": "not found"}, with_body=False)

            def _gate(self, endpoint: str | None) -> bool:
                """Record the echoed epoch; False (answered or cut) when this
                hive is dark, or refuses `endpoint` as not-primary."""
                with hive._cond:
                    hive.requests.append((time.monotonic(), self.path,
                                          self.headers.get("X-Hive-Epoch")))
                    dark, refusing = hive.dark, endpoint in hive.refusing
                if dark:
                    self.close_connection = True
                    return False
                if refusing:
                    self._reply(409, {"message": hive.refusal})
                    return False
                return True

            def do_GET(self):
                if self._file(with_body=True):
                    return
                url = urllib.parse.urlparse(self.path)
                if not self._gate("work" if url.path == "/api/work" else None):
                    return
                if url.path.startswith("/api/artifacts/"):
                    if not self._authorized():
                        return
                    with hive._cond:
                        blob = hive.artifacts.get(url.path[len("/api/artifacts/"):])
                    if blob is None:
                        return self._reply(404, {"message": "no such artifact"})
                    return self._bytes(blob, "application/octet-stream", True)
                if url.path != "/api/work":
                    return self._reply(404, {"message": "not found"})
                if not self._authorized():
                    return
                params = dict(urllib.parse.parse_qsl(url.query))
                reply = hive._work(params)
                self._reply(200, reply)

            def do_POST(self):
                path = urllib.parse.urlparse(self.path).path
                parts = path.strip("/").split("/")
                if path != "/api/results" and not (
                        len(parts) == 4 and parts[:2] == ["api", "jobs"]
                        and parts[3] in ("checkpoint", "preview")):
                    return self._reply(404, {"message": "not found"})
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if not self._gate("results" if path == "/api/results" else None):
                    return
                if not self._authorized():
                    return
                body = json.loads(raw)
                if path != "/api/results":
                    status, ack = hive._partial(parts[3], urllib.parse.unquote(parts[2]), body)
                    return self._reply(status, ack)
                status, ack = hive._result(body, raw)
                if status is None:
                    # the hive died before its answer: no response at all
                    self.close_connection = True
                    return
                self._reply(status, ack)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def _work(self, params: dict) -> dict:
        """One /work reply: the queued jobs (none to a cancel-only poll),
        resume offers on redeliveries to resume-capable pollers, and the
        pending revocations."""
        with self._cond:
            self.polls.append(params)
            jobs = []
            if params.get("cancel_only") != "1":
                stages = set((params.get("stages") or "").split(",")) if "stages" in params else None
                # a stage-job leaves only with a poller that advertised it
                jobs = [j for j in self.jobs if self._handed_to(j, stages)]
                self.jobs = [j for j in self.jobs if not self._handed_to(j, stages)]
            else:
                for job_id in list(self.cancel_on_polls):
                    self.cancel_on_polls[job_id] -= 1
                    if self.cancel_on_polls[job_id] <= 0:
                        del self.cancel_on_polls[job_id]
                        self.pending_cancels.append(job_id)
            handed = []
            for job in jobs:
                job_id = str(job.get("id"))
                ck = self.checkpoints.get(job_id)
                if (job_id in self._redelivered and ck is not None
                        and params.get("resume_capable") == "1"):
                    job = {**job, "resume": {"href": f"/api/artifacts/{ck['sha256']}",
                                             "step": ck["step"], "signature": ck["signature"]}}
                self._redelivered.discard(job_id)
                self.handed[job_id] = time.monotonic()
                handed.append(job)
            reply = {"jobs": handed}
            if self.pending_cancels:
                reply["cancels"], self.pending_cancels = sorted(set(self.pending_cancels)), []
                now = time.monotonic()
                for job_id in reply["cancels"]:
                    self.cancels_sent.setdefault(job_id, now)
            return reply

    @staticmethod
    def _handed_to(job: dict, stages: set | None) -> bool:
        stage = job.get("stage")
        if not isinstance(stage, dict):
            return True
        return stages is not None and stage.get("name") in stages

    def _result(self, body: dict, raw: bytes) -> tuple[int | None, dict]:
        """One result POST -> (status, ack); status None cuts the
        connection before the answer."""
        job_id = str(body.get("id"))
        with self._cond:
            self.result_attempts += 1
            if self.drop_results_times > 0:
                self.drop_results_times -= 1
                return None, {}
            if job_id in self.refusals:
                return self.refusals[job_id], {"message": f"result for {job_id} refused"}
            disposition = self.dispositions.get(job_id)
            if disposition is not None:
                self.disposed.append(body)
                self._cond.notify_all()
                return 200, {"id": job_id, "status": disposition, disposition: True}
            self.results.append(body)
            self.bodies.setdefault(job_id, []).append(raw)
            self.settled[job_id] = time.monotonic()
            if job_id in self._stage_of:
                self._settle_stage(job_id, body)
            self._cond.notify_all()
        return 200, {"ok": True, "id": body.get("id")}

    # --- stage graphs ---

    def submit_workflow(self, payload: dict, workflow_id: str) -> list[str]:
        """Expand a txt2img submission into its stage-jobs (dag.py
        `_expand_diffusion`) and queue the ready ones; -> the stage ids."""
        base = {k: v for k, v in payload.items() if k not in ("id", "stages", "links",
                                                              "image_stage")}
        model = base["model_name"]
        inherit = {k: payload[k] for k in ("tenant", "priority", "sdaas_priority", "ttl_s")
                   if k in payload}
        tiny = (base.get("parameters") or {}).get("test_tiny_model") or base.get("test_tiny_model")
        workflow = base.get("workflow", "txt2img")
        stages = []

        def stage(index: int, name: str, needs: list, job: dict, handoff=None) -> None:
            job = dict(job, id=f"{workflow_id}-s{index}-{name}")
            job["stage"] = {"workflow": workflow_id, "name": name, "index": index,
                            "needs": list(needs)}
            if handoff:
                job["stage"]["handoff"] = handoff
            stages.append({"name": name, "index": index, "needs": list(needs),
                           "job_id": job["id"], "state": "blocked", "job": job})

        stage(0, "encode", [], {"workflow": workflow, "model_name": model,
                                "prompt": base.get("prompt", ""),
                                "negative_prompt": base.get("negative_prompt", ""),
                                **({"parameters": {"test_tiny_model": True}} if tiny else {}),
                                **inherit})
        denoise = dict(base)
        denoise.pop("upscale", None)
        stage(1, "denoise", [0], denoise, handoff="raw")
        prev = 1
        if base.get("upscale"):
            stage(2, "upscale", [1], {
                "workflow": workflow, "model_name": model, "prompt": base.get("prompt", ""),
                "upscale": base.get("upscale"),
                **({"parameters": dict(base["parameters"])}
                   if isinstance(base.get("parameters"), dict) else {}),
                **inherit}, handoff="raw")
            prev = 2
        stage(prev + 1, "decode", [prev], {
            "workflow": workflow, "model_name": model,
            **{k: base[k] for k in ("content_type", "outputs", "nsfw_filter") if k in base},
            **inherit}, handoff="raw")
        with self._cond:
            self.workflows[workflow_id] = {"payload": dict(payload), "stages": stages}
            for s in stages:
                self._stage_of[s["job_id"]] = (workflow_id, s["index"])
            self._admit(workflow_id)
        return [s["job_id"] for s in stages]

    def _admit(self, workflow_id: str) -> None:
        """Queue every blocked stage whose needs are done, with the
        predecessors' artifacts as its inputs (the caller holds the lock)."""
        stages = self.workflows[workflow_id]["stages"]
        for s in stages:
            if s["state"] != "blocked" or any(stages[n]["state"] != "done" for n in s["needs"]):
                continue
            job = dict(s["job"])
            job["stage"] = dict(job["stage"])
            inputs = [{"stage": stages[n]["name"], "index": n,
                       "artifacts": dict(stages[n].get("artifacts") or {})}
                      for n in s["needs"]]
            if inputs:
                job["stage"]["inputs"] = inputs
            s["state"] = "queued"
            s["admitted_at"] = time.monotonic()
            self.jobs.append(job)

    def _settle_stage(self, job_id: str, body: dict) -> None:
        """A stage-job's result: its artifacts go to the spool, the stage is
        done (failed on a fatal envelope) and its successors are admitted
        (the caller holds the lock)."""
        workflow_id, index = self._stage_of[job_id]
        s = self.workflows[workflow_id]["stages"][index]
        refs = {}
        for key, art in (body.get("artifacts") or {}).items():
            if not isinstance(art, dict) or not isinstance(art.get("blob"), str):
                continue
            blob = base64.b64decode(art["blob"])
            digest = hashlib.sha256(blob).hexdigest()
            self.artifacts[digest] = blob
            refs[key] = {"sha256": digest, "bytes": len(blob),
                         "href": f"/api/artifacts/{digest}",
                         "content_type": art.get("content_type")}
        s["artifacts"], s["result"] = refs, body
        s["state"] = "failed" if body.get("fatal_error") else "done"
        s["settled_at"] = time.monotonic()
        self._admit(workflow_id)

    def workflow(self, workflow_id: str) -> dict:
        """{"state", "stages": [{name, job_id, state}], "result": the final
        stage's envelope once the graph is done}."""
        with self._cond:
            stages = self.workflows[workflow_id]["stages"]
            states = [s["state"] for s in stages]
            state = ("failed" if "failed" in states else
                     "done" if all(st == "done" for st in states) else "running")
            return {"state": state,
                    "stages": [{"name": s["name"], "job_id": s["job_id"], "state": s["state"]}
                               for s in stages],
                    "result": stages[-1].get("result") if state == "done" else None}

    def wait_for_workflow(self, workflow_id: str, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            status = self.workflow(workflow_id)
            if status["state"] != "running":
                return status
            with self._cond:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"workflow {workflow_id}: {status['stages']}")
                self._cond.wait(min(left, 0.5))

    # --- several hives ---

    def not_primary(self, epoch: int | None = None, endpoints: tuple = ("work", "results"),
                    message: str = NOT_PRIMARY) -> None:
        """Answer `endpoints` with 409 and `message`, advertising `epoch`."""
        with self._cond:
            if epoch is not None:
                self.epoch = int(epoch)
            self.refusing = set(endpoints)
            self.refusal = message

    def promote(self, epoch: int | None = None) -> None:
        """Serve every endpoint again (at `epoch`, when given)."""
        with self._cond:
            if epoch is not None:
                self.epoch = int(epoch)
            self.refusing = set()

    def go_dark(self) -> None:
        with self._cond:
            self.dark = True

    def enqueue_gang(self, *jobs: dict) -> str:
        """Queue `jobs` as one gang (handed in one reply, each stamped with
        its gang context); -> the gang id."""
        with self._cond:
            self._gangs += 1
            gang_id = f"gang-{self._gangs}"
            for index, job in enumerate(jobs):
                self.jobs.append({**job, "trace": {
                    "id": job["id"], "attempt": 1,
                    "gang": {"id": gang_id, "size": len(jobs), "index": index}}})
        return gang_id

    @property
    def epochs_seen(self) -> list[tuple[str, str | None]]:
        """(path, the X-Hive-Epoch it echoed or None) of every request."""
        with self._cond:
            return [(path, epoch) for _, path, epoch in self.requests]

    @property
    def duplicates(self) -> int:
        """Stored result POSTs beyond the first of their job id."""
        with self._cond:
            return sum(len(b) - 1 for b in self.bodies.values())

    def refuse(self, job_id: str, status: int = 422) -> None:
        """Answer `job_id`'s result POSTs with the 4xx `status`."""
        with self._cond:
            self.refusals[str(job_id)] = int(status)

    def dispose(self, job_id: str, disposition: str = "cancelled") -> None:
        """ACK `job_id`'s result POSTs with `disposition` ("cancelled",
        "expired" or "unknown_job") and store nothing."""
        with self._cond:
            self.dispositions[str(job_id)] = str(disposition)

    def _partial(self, kind: str, job_id: str, body: dict) -> tuple[int, dict]:
        try:
            blob = base64.b64decode(body["blob"], validate=True)
        except (KeyError, TypeError, binascii.Error, ValueError):
            return 400, {"message": "body must carry a base64 `blob`"}
        step = int(body.get("step", 0))
        if kind == "checkpoint":
            self.put_checkpoint(job_id, blob, step, str(body.get("signature", "")))
        digest = hashlib.sha256(blob).hexdigest()
        with self._cond:
            self.artifacts[digest] = blob
            record = {"kind": kind, "job_id": job_id, "step": step, "sha256": digest,
                      "bytes": len(blob), "at": time.monotonic(),
                      **{k: body[k] for k in ("signature", "content_type", "worker_name")
                         if k in body}}
            self.partials.append(record)
            if job_id in self.cancel_on_partial:
                self.cancel_on_partial.discard(job_id)
                self.pending_cancels.append(job_id)
            self._cond.notify_all()
        if kind == "checkpoint":
            return 200, {"status": "ok", "step": step, "sha256": digest}
        return 200, {"status": "ok", "step": step, "href": f"/api/artifacts/{digest}"}

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def enqueue(self, *jobs: dict) -> None:
        with self._cond:
            self.jobs.extend(jobs)

    def put_checkpoint(self, job_id: str, blob: bytes, step: int, signature: str) -> str:
        """Keep `blob` as `job_id`'s newest checkpoint; returns its sha256."""
        digest = hashlib.sha256(blob).hexdigest()
        with self._cond:
            self.artifacts[digest] = bytes(blob)
            self.checkpoints[str(job_id)] = {"step": int(step), "sha256": digest,
                                             "signature": signature, "bytes": len(blob)}
        return digest

    def redeliver(self, job: dict) -> None:
        """Queue `job` again as a redelivery, offering its newest checkpoint
        to a resume-capable poller."""
        with self._cond:
            self._redelivered.add(str(job.get("id")))
            self.jobs.append(dict(job))

    def cancel(self, job_id: str) -> None:
        """Revoke `job_id` on the next reply."""
        with self._cond:
            self.pending_cancels.append(str(job_id))

    def cancel_after_first_partial(self, job_id: str) -> None:
        """Revoke `job_id` on the first reply after its first checkpoint or
        preview arrives."""
        with self._cond:
            self.cancel_on_partial.add(str(job_id))

    def cancel_on_heartbeat(self, job_id: str, polls: int = 1) -> None:
        """Revoke `job_id` on the `polls`-th cancel-only poll from now (the
        worker polls so only while its device is busy)."""
        with self._cond:
            self.cancel_on_polls[str(job_id)] = int(polls)

    def enqueue_file(self, name: str, data: bytes, content_type: str) -> str:
        """Serve `data` under /files/<name>; returns its URI."""
        with self._cond:
            self.files[name] = (bytes(data), content_type)
        return f"{self.uri}/files/{urllib.parse.quote(name)}"

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
