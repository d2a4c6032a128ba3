"""Golden-fixture replay: apiserver-semantics transcripts over the wire.

The port's copy of kubeflow_tpu/kube/fixtures.py.

The reference grounds its controllers against a REAL kube-apiserver via
envtest (notebook-controller/controllers/suite_test.go:50-110), so apiserver
semantics — optimistic concurrency, generation bumps, RFC 7386 merge
patches, finalizer-gated deletion, owner-ref GC, watch resume/410 — are
independently enforced.  This module replays declarative golden transcripts
(conformance/apiserver_fixtures/*.json), each step recording the behavior a
real kube-apiserver exhibits, against ANY server speaking the k8s REST
protocol:

  - this repo's wire server (tests/test_apiserver_fixtures.py) — a
    store-semantics bug shows up as a fixture diff, not a green self-test;
  - a real cluster (`python -m kubeflow_tpu_torch.kube.fixtures --server URL`),
    which is how the transcripts themselves are validated.

Known divergences are fixtures too: a fixture with an `expected_divergence`
marker pins BOTH behaviors — each diverging step carries `expect` (this
implementation, asserted by default so regressions in the documented
behavior are caught) and `expect_real` (what a genuine kube-apiserver
answers, asserted under `--real` so the divergence is adjudicated the day
the replay runs against a real cluster).

Fixture format — a JSON object:
  {"name": ..., "kube_semantics": "<what real k8s does, with source>",
   "steps": [{"op": "POST|GET|PUT|PATCH|DELETE|WATCH",
              "path": "/apis/...",            # ${var} substituted
              "body": {...},                  # ${var} substituted, deep
              "content_type": "...",          # PATCH merge type
              "repeat": N,                    # ${i} = iteration index
              "capture": {"var": "dotted.path"},
              "expect": {"status": 201,
                         "equals": {"dotted.path": value},
                         "startswith": {"dotted.path": "prefix"},
                         "absent": ["dotted.path"],
                         "exists": ["dotted.path"],
                         "events": [{"type": "ADDED",
                                     "name": "..."}, ...]}}]}
"""

from __future__ import annotations

import json
import ssl
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Optional


def dig(obj: Any, path: str) -> Any:
    """Dotted-path lookup; integer segments index lists.  Raises KeyError
    with the full path on a miss."""
    cur = obj
    for seg in path.split("."):
        try:
            if isinstance(cur, list):
                cur = cur[int(seg)]
            else:
                cur = cur[seg]
        except (KeyError, IndexError, TypeError, ValueError):
            raise KeyError(f"{path} (at segment {seg!r})") from None
    return cur


def substitute(value: Any, variables: dict[str, Any]) -> Any:
    """Deep ${var} substitution in strings; a string that is exactly one
    placeholder keeps the captured value's type."""
    if isinstance(value, str):
        if value.startswith("${") and value.endswith("}") and \
                value.count("${") == 1:
            return variables[value[2:-1]]
        out = value
        for k, v in variables.items():
            out = out.replace("${" + k + "}", str(v))
        return out
    if isinstance(value, dict):
        return {k: substitute(v, variables) for k, v in value.items()}
    if isinstance(value, list):
        return [substitute(v, variables) for v in value]
    return value


class FixtureFailure(AssertionError):
    pass


class FixtureRunner:
    """Replays one fixture against a server base URL."""

    def __init__(self, server: str, token: str = "",
                 ssl_context: Optional[ssl.SSLContext] = None,
                 timeout_s: float = 10.0, real: bool = False,
                 clock=None) -> None:
        self.server = server.rstrip("/")
        self.token = token
        self.ctx = ssl_context
        self.timeout_s = timeout_s
        # real=True: the target is a genuine apiserver — steps with an
        # `expect_real` block assert it instead of `expect`
        self.real = real
        # retry pacing (clock discipline: a FakeClock makes retry loops
        # instant in tests; a real Clock sleeps between attempts)
        if clock is None:
            from ..utils.clock import Clock
            clock = Clock()
        self.clock = clock

    # -- transport ------------------------------------------------------------
    def _request(self, method: str, path: str, body: Any = None,
                 content_type: str = "application/json") -> tuple[int, Any]:
        headers = {"Content-Type": content_type, "Accept": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.server + path,
            data=json.dumps(body).encode() if body is not None else None,
            headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s,
                                        context=self.ctx) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else {}
        except urllib.error.HTTPError as err:
            raw = err.read()
            try:
                return err.code, json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                return err.code, {"raw": raw.decode(errors="replace")}

    def _watch(self, path: str, max_events: int,
               timeout_s: float = 5.0) -> tuple[int, Any]:
        """Open a watch stream, read up to max_events event lines."""
        headers = {"Accept": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(self.server + path, headers=headers)
        try:
            resp = urllib.request.urlopen(req, timeout=timeout_s,
                                          context=self.ctx)
        except urllib.error.HTTPError as err:
            raw = err.read()
            try:
                return err.code, json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                return err.code, {}
        events = []
        try:
            while len(events) < max_events:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if line:
                    events.append(json.loads(line))
        except (TimeoutError, OSError):
            pass
        finally:
            resp.close()
        return 200, {"events": events}

    # -- replay ---------------------------------------------------------------
    def run(self, fixture: dict) -> None:
        """Raises FixtureFailure on the first divergence."""
        variables: dict[str, Any] = {}
        for idx, step in enumerate(fixture.get("steps", [])):
            repeat = int(step.get("repeat", 1))
            for i in range(repeat):
                variables["i"] = i
                self._run_step(fixture, idx, step, variables)

    def _run_step(self, fixture: dict, idx: int, step: dict,
                  variables: dict[str, Any]) -> None:
        """One step, with optional retry_s — real-cluster effects the
        in-memory store applies synchronously (GC cascades, finalizer
        completion) are asynchronous on a genuine apiserver."""
        deadline = self.clock.monotonic() + float(step.get("retry_s", 0))
        while True:
            try:
                self._attempt_step(fixture, idx, step, variables)
                return
            except FixtureFailure:
                if self.clock.monotonic() >= deadline:
                    raise
                self.clock.sleep(0.25)

    def _attempt_step(self, fixture: dict, idx: int, step: dict,
                      variables: dict[str, Any]) -> None:
        label = f"{fixture.get('name', '?')}#{idx} {step.get('op')} " \
                f"{step.get('path')}"
        op = step["op"].upper()
        path = substitute(step["path"], variables)
        body = substitute(step.get("body"), variables) \
            if "body" in step else None
        expect = step.get("expect", {})
        if self.real and "expect_real" in step:
            expect = step["expect_real"]
        if op == "WATCH":
            max_events = len(expect.get("events", [])) or 1
            status, payload = self._watch(
                path, max_events, timeout_s=float(step.get("timeout_s", 5.0)))
        else:
            status, payload = self._request(
                op, path, body,
                content_type=step.get("content_type", "application/json"))

        want_status = expect.get("status")
        if want_status is not None and status != want_status:
            raise FixtureFailure(
                f"{label}: status {status} != {want_status}; body={payload}")
        for path_expr, want in expect.get("equals", {}).items():
            want = substitute(want, variables)
            try:
                got = dig(payload, path_expr)
            except KeyError as err:
                raise FixtureFailure(f"{label}: missing {err}") from None
            if got != want:
                raise FixtureFailure(
                    f"{label}: {path_expr} = {got!r} != {want!r}")
        for path_expr, prefix in expect.get("startswith", {}).items():
            got = dig(payload, path_expr)
            if not str(got).startswith(substitute(prefix, variables)):
                raise FixtureFailure(
                    f"{label}: {path_expr} = {got!r} !startswith {prefix!r}")
        for path_expr in expect.get("exists", []):
            try:
                dig(payload, path_expr)
            except KeyError as err:
                raise FixtureFailure(f"{label}: missing {err}") from None
        for path_expr in expect.get("absent", []):
            try:
                got = dig(payload, path_expr)
            except KeyError:
                continue
            if got is not None:
                raise FixtureFailure(
                    f"{label}: {path_expr} present ({got!r}), expected absent")
        for ev_idx, want_ev in enumerate(expect.get("events", [])):
            events = payload.get("events", [])
            if ev_idx >= len(events):
                raise FixtureFailure(
                    f"{label}: only {len(events)} events, wanted "
                    f"{len(expect['events'])}")
            got_ev = events[ev_idx]
            if got_ev.get("type") != want_ev["type"]:
                raise FixtureFailure(
                    f"{label}: event[{ev_idx}].type {got_ev.get('type')} != "
                    f"{want_ev['type']}")
            want_name = substitute(want_ev.get("name", ""), variables)
            got_name = got_ev.get("object", {}).get("metadata", {}).get("name")
            if want_name and got_name != want_name:
                raise FixtureFailure(
                    f"{label}: event[{ev_idx}].name {got_name} != {want_name}")
        for var, path_expr in step.get("capture", {}).items():
            try:
                variables[var] = dig(payload, path_expr)
            except KeyError as err:
                raise FixtureFailure(
                    f"{label}: capture {var}: missing {err}") from None


FIXTURE_DIR = Path(__file__).resolve().parents[2] / "conformance" / \
    "apiserver_fixtures"


def load_fixtures(directory: Optional[Path] = None) -> list[dict]:
    directory = directory or FIXTURE_DIR
    out = []
    for f in sorted(directory.glob("*.json")):
        fixture = json.loads(f.read_text())
        fixture.setdefault("name", f.stem)
        out.append(fixture)
    return out


def main(argv: Optional[list] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="replay apiserver golden fixtures against a server")
    parser.add_argument("--server", required=True,
                        help="base URL (http[s]://host:port)")
    parser.add_argument("--token", default="")
    parser.add_argument("--insecure", action="store_true")
    parser.add_argument("--fixtures", default=str(FIXTURE_DIR))
    parser.add_argument("--real", action="store_true",
                        help="target is a genuine apiserver: skip fixtures "
                             "marked skip_on_real (deterministic history "
                             "aging needs the in-memory window)")
    args = parser.parse_args(argv)
    ctx = ssl._create_unverified_context() if args.insecure else None
    runner = FixtureRunner(args.server, token=args.token, ssl_context=ctx,
                           real=args.real)
    failures = 0
    for fixture in load_fixtures(Path(args.fixtures)):
        if args.real and fixture.get("skip_on_real"):
            print(f"SKIP {fixture['name']} (skip_on_real)")
            continue
        tag = " (expected_divergence: asserting real-apiserver side)" \
            if args.real and fixture.get("expected_divergence") else ""
        try:
            runner.run(fixture)
            print(f"PASS {fixture['name']}{tag}")
        except FixtureFailure as err:
            failures += 1
            print(f"FAIL {fixture['name']}{tag}: {err}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
