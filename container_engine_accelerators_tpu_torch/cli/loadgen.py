"""loadgen — serving load generator with time-to-first-token metrics,
the port's copy of the JAX package's: the same flags, traffic and
summary JSON, driving `cli/serve.py` of either package over HTTP.

Modes:
  default    one-shot /generate POSTs; reports request latency.
  --stream   SSE /generate (stream=true); additionally reports TTFT =
             first `data:` event arrival minus request start, and TPOT
             = inter-token gaps, per request, as p50/p90/p99.

Multi-tenant mix (--tenants N): request i belongs to tenant i % N;
every tenant's requests share a deterministic per-tenant system prefix
(--tenant-prefix-len tokens), so a prefix-cache-enabled server
(`serve --engine paged`) sees repeat hits per tenant and /metrics
shows a nonzero serve_prefix_hit_rate. Odd tenants are "batch" class
and send long prompts (--long-prompt-len); even tenants stay "chat"
class at --prompt-len. --idle-tenants and --churn-tenants carve
think-time and prefix-churning tenants off the top of the range (cold
pages and prefix thrash for the KV thermal census). The summary grows a
per-tenant block (TTFT/TPOT percentiles and SLO verdicts when gating);
a violation in any tenant fails the run.

SLO gating:
  --slo-ttft-p99-ms M   fail unless client-observed TTFT p99 <= M
  --slo-tpot-p99-ms M   fail unless pooled inter-token-gap p99 <= M
Both require --stream (the latencies are client-clocked).

Failure accounting: every request resolves to one outcome —

  ok                completed
  structured_error  the server said it failed: an `{"error": ...}` SSE
                    event or error-JSON body (a clean failure)
  hung              a stream produced no event for --stall-timeout-s
  transport_error   connection refused/reset, bad HTTP, timeouts

The summary JSON reports all four; `errors` is the total failed count.
Exit codes: transport errors exit 1 ("server unreachable/broke"); SLO
violations, structured errors and hung streams exit 3 ("server answered
but broke its promises").

Request tracing: `--trace-sample-rate R` head-samples the client's
request indices with the same deterministic hash the server uses
(metrics/trace.head_sampled), and each sampled POST carries
`"trace": true` plus `"tags": {"tenant": t, "class": chat|batch}`: the
server forces those requests into the trace and stamps the tags into
every span's args. Server-side tail sampling still captures
failed/preempted/SLO-violating requests regardless of this rate.

Fan-out: `--targets a,b,c` round-robins request i onto server i % N
and adds a per-target outcome/latency block to the summary.

Prints one human line per percentile block, an `SLO PASS|FAIL` line
when gating, an outcome line when anything failed, and a final JSON
summary line.

  python -m container_engine_accelerators_tpu_torch.cli.loadgen \
      --url http://127.0.0.1:8000 --requests 64 --concurrency 16 \
      --tenants 4 --stream --trace-sample-rate 1.0
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import time
import urllib.request

from container_engine_accelerators_tpu_torch.metrics.trace import head_sampled


def percentiles(xs: list[float], ps=(50, 90, 99)) -> dict[str, float]:
    if not xs:
        return {f"p{p}": float("nan") for p in ps}
    xs = sorted(xs)
    out = {}
    for p in ps:
        idx = min(int(round(p / 100 * (len(xs) - 1))), len(xs) - 1)
        out[f"p{p}"] = xs[idx]
    return out


class StreamStalled(Exception):
    """No SSE event for the stall timeout: the stream is wedged, not
    failing cleanly."""


def tenant_class(tenant: int, args=None) -> str:
    """Odd tenants run long-prompt "batch" traffic, even ones chatty
    "chat" traffic — interleaving the two is the whole point of the
    mix. With --idle-tenants/--churn-tenants the TOP of the
    tenant range is carved off first: the last `idle_tenants` tenants
    are "idle" (long think-time sessions whose prefix pages sit
    resident and go cold) and the `churn_tenants` before them are
    "churn" (their system prefix cycles through more variants than the
    server's prefix cache holds, forcing evict-then-re-reference
    thrash). Passing args is optional so legacy callers keep the
    two-class layout."""
    if args is not None:
        idle_n = getattr(args, "idle_tenants", 0) or 0
        churn_n = getattr(args, "churn_tenants", 0) or 0
        n = getattr(args, "tenants", 0) or 0
        if n and tenant >= n - idle_n:
            return "idle"
        if n and tenant >= n - idle_n - churn_n:
            return "churn"
    return "batch" if tenant % 2 else "chat"


def tenant_tokens(args, i: int) -> tuple[int, list[int]]:
    """(tenant, prompt) for request i of a multi-tenant mix. The
    prefix depends only on the TENANT (their shared system prompt —
    deterministic, so repeat requests hit the server's prefix cache);
    the suffix depends on the request (each conversation differs).
    Churn tenants break that rule on purpose: their prefix also
    depends on the request's cycle position (i // tenants mod
    --churn-cycle), so successive rounds reference MORE prefix
    variants than the cache retains."""
    t = i % args.tenants
    cls = tenant_class(t, args)
    variant = 0
    if cls == "churn":
        variant = (i // args.tenants) % max(
            getattr(args, "churn_cycle", 1), 1)
    # The variant multiplier must keep (t*31 + v*17) mod 97 distinct
    # across every coexisting (tenant, variant) pair — a churn variant
    # that lands on another tenant's offset silently SHARES that
    # tenant's prefix pages (first-owner-wins attribution then charges
    # them to the wrong tenant). 17 is collision-free for <=8 tenants
    # x 8-variant cycles; 53 aliased churn variants onto idle tenants.
    prefix = [(t * 31 + variant * 17 + j) % 97 + 1
              for j in range(args.tenant_prefix_len)]
    body_len = (args.long_prompt_len if cls == "batch"
                else args.prompt_len)
    body = [(i * 7 + j) % 100 + 1 for j in range(body_len)]
    return t, prefix + body


def _slo_block(ttfts, gaps, args):
    """(slo dict | None, violated) for one sample population — used
    for the pooled gate and again per tenant. NaN (no samples) fails
    closed: a population that produced no tokens cannot claim it met
    a latency SLO."""
    checks = []
    if args.slo_ttft_p99_ms is not None:
        obs = percentiles(ttfts)["p99"] * 1e3 if ttfts else float("nan")
        checks.append(("ttft_p99_ms", args.slo_ttft_p99_ms, obs))
    if args.slo_tpot_p99_ms is not None:
        obs = percentiles(gaps)["p99"] * 1e3 if gaps else float("nan")
        checks.append(("tpot_p99_ms", args.slo_tpot_p99_ms, obs))
    if not checks:
        return None, False
    slo, violated = {}, False
    for name, limit, obs in checks:
        ok = obs <= limit
        slo[name] = {"limit": limit,
                     "observed": round(obs, 2) if obs == obs else None,
                     "ok": bool(ok)}
        if not ok:
            violated = True
    return slo, violated


def one_request(url: str, tokens: list[int], max_new: int,
                stream: bool, timeout: float,
                stall_timeout: float | None = None,
                trace_tags: dict | None = None,
                force_trace: bool = True) -> dict:
    """Returns {"outcome": "ok"|"structured_error", "error": str|None,
    "latency": s, "ttft": s|None, "tokens": n_generated,
    "gaps": [inter-token seconds]} (gaps only in stream mode).
    Raises StreamStalled when a stream goes silent past
    `stall_timeout`; transport failures raise their own exceptions.
    `trace_tags` forces the server to trace this request and stamps
    the tags into every span's args."""
    body = {"tokens": tokens, "max_new_tokens": max_new}
    if stream:
        body["stream"] = True
    if trace_tags is not None:
        # Tags alone give the server tenant attribution (the thermal
        # census's per-tenant occupancy); "trace": true additionally
        # forces the request into the span trace.
        body["tags"] = trace_tags
        if force_trace:
            body["trace"] = True
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    # The socket timeout bounds each blocking read: in stream mode
    # that IS the event gap, so --stall-timeout-s rides it directly.
    read_timeout = (stall_timeout if stream and stall_timeout
                    else timeout)
    t0 = time.perf_counter()
    out = {"outcome": "ok", "error": None, "ttft": None, "tokens": 0,
           "gaps": []}
    try:
        with urllib.request.urlopen(req, timeout=read_timeout) as resp:
            if not stream:
                payload = json.loads(resp.read())
                out["latency"] = time.perf_counter() - t0
                if "error" in payload:
                    out["outcome"] = "structured_error"
                    out["error"] = str(payload["error"])
                    return out
                out["tokens"] = len(payload["tokens"]) - len(tokens)
                return out
            last_tok_t = None
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                ev = json.loads(line[len("data: "):])
                if "error" in ev:
                    out["outcome"] = "structured_error"
                    out["error"] = str(ev["error"])
                    break
                if "token" in ev:
                    now = time.perf_counter()
                    if out["ttft"] is None:
                        out["ttft"] = now - t0
                    else:
                        out["gaps"].append(now - last_tok_t)
                    last_tok_t = now
                    out["tokens"] += 1
                if ev.get("done"):
                    break
            out["latency"] = time.perf_counter() - t0
            return out
    except TimeoutError as e:
        if stream and stall_timeout:
            raise StreamStalled(
                f"no stream event for {stall_timeout:.1f}s") from e
        raise


def run(args) -> tuple[dict, int]:
    """Drive the load and return (summary, exit_code) — the in-process
    entry; main() wraps it for the CLI."""
    # Fan-out: --targets a,b,c round-robins request i onto target
    # i % N; attribution stays deterministic from the request index
    # even when the request itself dies in transport.
    targets = None
    if getattr(args, "targets", None):
        targets = [t.strip() for t in args.targets.split(",")
                   if t.strip()]

    def target_for(i: int) -> str:
        return targets[i % len(targets)] if targets else args.url

    def req_i(i: int) -> dict:
        if args.tenants:
            tenant, tokens = tenant_tokens(args, i)
        else:
            tenant = 0
            tokens = [(i * 7 + j) % 100 + 1
                      for j in range(args.prompt_len)]
        cls = tenant_class(tenant, args)
        # Tenant tags ride EVERY multi-tenant request (the server's
        # thermal census attributes pages by them); head-sampled
        # requests additionally force a span trace.
        trace_tags = ({"tenant": tenant, "class": cls}
                      if args.tenants else None)
        force = bool(args.trace_sample_rate
                     and head_sampled(i, args.trace_sample_rate))
        if trace_tags is None and force:
            trace_tags = {"tenant": tenant, "class": cls}
        if cls == "idle":
            # Think time: the session holds its prefix pages resident
            # while saying nothing — the cold-page producer. Slept
            # before the request clock starts, so idle tenants' TTFT
            # still measures the server, not the think time.
            time.sleep(getattr(args, "idle_think_s", 0.0) or 0.0)
        r = one_request(target_for(i), tokens, args.max_new_tokens,
                        args.stream, args.timeout,
                        stall_timeout=args.stall_timeout_s,
                        trace_tags=trace_tags, force_trace=force)
        r["tenant"] = tenant
        return r

    t0 = time.perf_counter()
    results = []
    structured_errors = hung_streams = transport_errors = 0
    per_target: dict[str, dict] = {
        url: {"requests_ok": 0, "structured_errors": 0,
              "hung_streams": 0, "transport_errors": 0,
              "latencies": []}
        for url in (targets or [])}

    def tally(i: int, key: str) -> None:
        if targets:
            per_target[target_for(i)][key] += 1

    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as ex:
        futs = [(i, ex.submit(req_i, i)) for i in range(args.requests)]
        for i, fut in futs:
            try:
                r = fut.result()
            except StreamStalled as e:
                hung_streams += 1
                tally(i, "hung_streams")
                print(f"request HUNG ({target_for(i)}): {e}")
                continue
            except Exception as e:
                transport_errors += 1
                tally(i, "transport_errors")
                print(f"request failed (transport, {target_for(i)}): "
                      f"{e}")
                continue
            if r["outcome"] == "structured_error":
                structured_errors += 1
                tally(i, "structured_errors")
                print(f"request failed (structured): {r['error']}")
            else:
                results.append(r)
                tally(i, "requests_ok")
                if targets:
                    per_target[target_for(i)]["latencies"].append(
                        r["latency"])
    wall = time.perf_counter() - t0
    errors = structured_errors + hung_streams + transport_errors

    lat = percentiles([r["latency"] for r in results])
    print(f"{len(results)}/{args.requests} ok in {wall:.1f}s "
          f"({len(results) / wall:.1f} req/s); latency "
          + " ".join(f"{k}={v * 1e3:.0f}ms" for k, v in lat.items()))
    if errors:
        print(f"outcomes: ok={len(results)} "
              f"structured_error={structured_errors} "
              f"hung={hung_streams} transport={transport_errors}")
    summary = {
        "requests_ok": len(results), "errors": errors,
        "structured_errors": structured_errors,
        "hung_streams": hung_streams,
        "transport_errors": transport_errors,
        "req_per_sec": round(len(results) / wall, 2),
        "latency_ms": {k: round(v * 1e3, 1) for k, v in lat.items()},
        "tokens_per_sec": round(
            sum(r["tokens"] for r in results) / wall, 1),
    }
    if targets:
        # Per-target verdicts: a dead server shows up as transport
        # errors concentrated on ONE url while the others stay clean.
        tblock = {}
        for url, t in per_target.items():
            entry = {k: t[k] for k in
                     ("requests_ok", "structured_errors",
                      "hung_streams", "transport_errors")}
            entry["latency_ms"] = {
                k: round(v * 1e3, 1) for k, v in
                percentiles(t["latencies"]).items()}
            tblock[url] = entry
            print(f"target {url}: ok={entry['requests_ok']} "
                  f"structured={entry['structured_errors']} "
                  f"hung={entry['hung_streams']} "
                  f"transport={entry['transport_errors']} "
                  f"latency_p99={entry['latency_ms']['p99']}ms")
        summary["targets"] = tblock
    slo_violated = False
    if args.stream:
        ttfts = [r["ttft"] for r in results if r["ttft"] is not None]
        tt = percentiles(ttfts)
        print("ttft " + " ".join(f"{k}={v * 1e3:.0f}ms"
                                 for k, v in tt.items()))
        summary["ttft_ms"] = {k: round(v * 1e3, 1) for k, v in tt.items()}
        gaps = [g for r in results for g in r["gaps"]]
        if gaps:
            tp = percentiles(gaps)
            print("tpot " + " ".join(f"{k}={v * 1e3:.1f}ms"
                                     for k, v in tp.items()))
            summary["tpot_ms"] = {k: round(v * 1e3, 2)
                                  for k, v in tp.items()}
        # SLO gate: one structured pass/fail line per objective plus a
        # `slo` block in the JSON summary.
        slo, slo_violated = _slo_block(ttfts, gaps, args)
        if slo is not None:
            summary["slo"] = slo
            verdict = "PASS" if not slo_violated else "FAIL"
            print(f"SLO {verdict} " + " ".join(
                f"{n}={v['observed']}/{v['limit']}"
                f"[{'ok' if v['ok'] else 'VIOLATED'}]"
                for n, v in slo.items()))
    if args.tenants:
        # Per-tenant verdicts: the pooled numbers hide exactly the
        # failure the mix exists to expose (a long-prefill tenant
        # wrecking the chatty tenants' TPOT), so each tenant gets its
        # own percentile block — and its own SLO verdict against the
        # same limits, any violation failing the run.
        tenants = {}
        for t in sorted({r["tenant"] for r in results}):
            rs = [r for r in results if r["tenant"] == t]
            entry = {"class": tenant_class(t, args),
                     "requests_ok": len(rs),
                     "latency_ms": {
                         k: round(v * 1e3, 1) for k, v in
                         percentiles([r["latency"] for r in rs]).items()}}
            line = (f"tenant {t} ({entry['class']}): ok={len(rs)} "
                    f"latency_p99={entry['latency_ms']['p99']}ms")
            if args.stream:
                t_ttfts = [r["ttft"] for r in rs
                           if r["ttft"] is not None]
                t_gaps = [g for r in rs for g in r["gaps"]]
                entry["ttft_ms"] = {k: round(v * 1e3, 1) for k, v in
                                    percentiles(t_ttfts).items()}
                if t_gaps:
                    entry["tpot_ms"] = {k: round(v * 1e3, 2) for k, v in
                                        percentiles(t_gaps).items()}
                t_slo, t_violated = _slo_block(t_ttfts, t_gaps, args)
                if t_slo is not None:
                    entry["slo"] = t_slo
                    entry["slo_ok"] = not t_violated
                    if t_violated:
                        slo_violated = True
                    line += (f" ttft_p99={entry['ttft_ms']['p99']}ms"
                             + (f" tpot_p99="
                                f"{entry['tpot_ms']['p99']}ms"
                                if t_gaps else "")
                             + f" SLO "
                             f"{'PASS' if not t_violated else 'FAIL'}")
            tenants[str(t)] = entry
            print(line)
        summary["tenants"] = tenants
    print(json.dumps(summary))
    # Transport errors mean the server broke mid-conversation (exit 1);
    # SLO violations, structured errors and hung streams mean it
    # answered but broke its promises (exit 3 covers all three).
    if transport_errors:
        return summary, 1
    if slo_violated or structured_errors or hung_streams:
        return summary, 3
    return summary, 0


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--targets", default=None,
                   help="comma-separated replica base URLs: request i "
                        "goes to target i %% N (round-robin fan-out "
                        "over several servers); the summary "
                        "gains a per-target outcome/latency block and "
                        "--url is ignored")
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--concurrency", type=int, default=4,
                   help="in-flight requests (exercises the continuous "
                        "engine's slot pool)")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--tenants", type=int, default=0,
                   help="multi-tenant mix: request i belongs to tenant "
                        "i %% N, each tenant's requests share a "
                        "deterministic system prefix (prefix-cache "
                        "hits server-side), odd tenants send long "
                        "prompts (--long-prompt-len) while even ones "
                        "stay at --prompt-len; the summary gains "
                        "per-tenant percentiles and SLO verdicts. "
                        "0 disables the mix")
    p.add_argument("--tenant-prefix-len", type=int, default=64,
                   help="shared system-prefix tokens per tenant "
                        "(page-multiple lengths make every page "
                        "shareable on a paged server)")
    p.add_argument("--long-prompt-len", type=int, default=256,
                   help="prompt body length for odd (batch-class) "
                        "tenants in the multi-tenant mix")
    p.add_argument("--idle-tenants", type=int, default=0,
                   help="carve this many tenants off the TOP of the "
                        "tenant range as 'idle' class: chat-length "
                        "prompts preceded by --idle-think-s of think "
                        "time per request, so their prefix pages sit "
                        "resident and go cold")
    p.add_argument("--idle-think-s", type=float, default=2.0,
                   help="seconds an idle-class request thinks before "
                        "sending (not counted in its latency)")
    p.add_argument("--churn-tenants", type=int, default=0,
                   help="carve this many tenants (below the idle "
                        "block) as 'churn' class: their system prefix "
                        "cycles through --churn-cycle variants, so a "
                        "cache smaller than the variant set evicts "
                        "pages it will re-reference")
    p.add_argument("--churn-cycle", type=int, default=8,
                   help="distinct prefix variants a churn tenant "
                        "cycles through")
    p.add_argument("--stream", action="store_true",
                   help="SSE mode: measure time-to-first-token and "
                        "inter-token gaps")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--stall-timeout-s", type=float, default=None,
                   help="stream mode: a request whose SSE stream "
                        "produces NO event for this many seconds "
                        "counts as a HUNG stream (wedged server) "
                        "instead of waiting out --timeout; hung "
                        "streams exit 3")
    p.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                   help="fail (exit 3) unless client-observed TTFT "
                        "p99 <= this; requires --stream")
    p.add_argument("--slo-tpot-p99-ms", type=float, default=None,
                   help="fail (exit 3) unless pooled inter-token-gap "
                        "p99 <= this; requires --stream")
    p.add_argument("--trace-sample-rate", type=float, default=0.0,
                   help="head-sample this fraction of requests for "
                        "server-side tracing: sampled POSTs carry "
                        "trace=true plus tenant/class tags that land "
                        "in every span's args (trace_report slices "
                        "its attribution table on them); the server "
                        "still tail-samples failed/preempted/SLO-"
                        "violating requests on its own")
    return p


def main(argv=None) -> int:
    p = make_parser()
    args = p.parse_args(argv)
    if ((args.slo_ttft_p99_ms is not None
         or args.slo_tpot_p99_ms is not None) and not args.stream):
        p.error("--slo-ttft-p99-ms/--slo-tpot-p99-ms require --stream "
                "(the latencies are client-clocked off the SSE feed)")
    if args.stall_timeout_s is not None and not args.stream:
        p.error("--stall-timeout-s requires --stream (hung-stream "
                "detection reads the SSE event gaps)")
    if args.idle_tenants + args.churn_tenants > args.tenants:
        p.error("--idle-tenants + --churn-tenants cannot exceed "
                "--tenants (they carve classes out of the tenant "
                "range)")
    _, rc = run(args)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
