"""The plan-quality plane's standing contracts, single-node.

Port of ``scripts/planqual_bench.py``'s first three halves (its
constants, record fields and gates, each cited by line), over any
package's ``Database`` and the metrics module of the same package (the
port's by default):

  coverage  the TPC-H queries with the ``*key`` secondary indexes: every
            operator row of each query's plan-monitor record carries an
            estimate with ``q_error >= 1``; over gv$plan_choice, >= 5
            enumerated plans, >= 1 with a runner-up, and predicted
            seconds ranking the executed plans as measured device seconds
            do in at least half the pairs, or no pair to rank
            (``planqual_bench.py:73-196``, gates :393-416);
  overhead  the plan monitor and cardinality feedback off against on
            over the slice's q6 and q1, in interleaved samples of 2
            passes, compared by the median per mode
            (``planqual_bench.py:199-263``); the contract is <= 2%;
  feedback  a seeded 100 x 100 join on one duplicate key: one
            CapacityOverflow retry with feedback on, then 0 in a fresh
            session; >= 2 on the blind ladder with it off
            (``planqual_bench.py:265-307``).

  skew      over any package's node processes (``bench/cluster.py``): a
            table whose every row matching ``flag = 1`` hashes, by the
            port's ``px/dtl.py::slice_mask``, into slice 0, and one of
            random keys; the pushed-down filter's gv$px_exchange
            ``slice_skew`` reads >= 3.0 for the first and < 1.5 for the
            second (``planqual_bench.py:314-375``, gate :411-414).
"""

from __future__ import annotations

import os

import numpy as np

from oceanbase_tpu_torch.bench import planes
from oceanbase_tpu_torch.bench.cluster import lead_from, rows as rows_of
from oceanbase_tpu_torch.bench.tpch_queries import QUERIES
from oceanbase_tpu_torch.server import metrics as port_metrics

SF = 0.1                # ``planqual_bench.py:50`` (PLANQUAL_SF)
REPEATS = 96            # ``planqual_bench.py:53`` (PLANQUAL_REPEATS)
ROWS = 20_000           # ``planqual_bench.py:199``
PER_SAMPLE = 2          # ``planqual_bench.py:228``
MIN_SAMPLES = 8         # ``planqual_bench.py:229``
JOIN_ROWS = 100         # ``planqual_bench.py:265``
JOIN_QUERY = "select count(*) from fa, fb where fa.k = fb.k"   # :282
JOIN_ANSWER = [(JOIN_ROWS * JOIN_ROWS,)]
MIN_ENUMERATED = 5      # ``planqual_bench.py:399``
MIN_RUNNER_UP = 1       # ``planqual_bench.py:400``
MIN_RANKING = 0.5       # ``planqual_bench.py:403``
OVERHEAD_KNOBS = ("enable_sql_plan_monitor", "enable_plan_feedback")
COVERAGE_KNOBS = ("plan_monitor_sample_every",)
SKEW_ROWS = 3000        # ``planqual_bench.py:314``
SKEW_PARTS = 3          # the cluster's nodes (``planqual_bench.py:320``)
SKEW_SEED = 5           # ``planqual_bench.py:345``
SKEW_BATCH = 1000       # ``planqual_bench.py:336``
SKEWED_MIN = 3.0        # ``planqual_bench.py:413``
UNIFORM_MAX = 1.5       # ``planqual_bench.py:414``
QUERY_S = 60.0


def key_indexes(tables: dict) -> list[tuple[str, str, str]]:
    """(index, table, column) for every ``*key`` column, named as the
    reference names them (``planqual_bench.py:93-98``)."""
    return [(f"idx_{name}_{c}", name, c) for name, arrays in tables.items()
            for c in arrays if c.endswith("key")]


def coverage(db, queries=QUERIES, sample_every: int | None = None) -> dict:
    """The coverage half on ``db``, whose TPC-H tables are loaded,
    ANALYZEd and carry the ``*key`` indexes -> the reference's record
    (without its generation seconds).  The reference runs on a fresh
    database, where each query's first executions always reach the plan
    monitor; on one that ran them before, ``sample_every = 1`` keeps
    that (restored on the way out), and the cost-model counts read only
    the plans of these queries."""
    s = db.session()
    with planes.kept(db, COVERAGE_KNOBS):
        if sample_every is not None:
            planes.alter(s, "plan_monitor_sample_every", sample_every)
        per_query, lhashes = {}, set()
        worst = {"q": None, "op": "", "q_error": 0.0}
        for qnum in sorted(queries):
            s.execute(queries[qnum])
            rec = db.plan_monitor.recent(1)[-1]
            lhashes.add(rec.logical_hash)
            with_est = sum(1 for r in rec.op_stats
                           if r.get("est") is not None
                           and r.get("q_error", 0.0) >= 1.0)
            qmax = max(rec.op_stats, key=lambda r: r.get("q_error", 0.0))
            per_query[f"q{qnum}"] = {
                "operators": len(rec.op_stats), "with_qerror": with_est,
                "max_q_error": round(qmax.get("q_error", 0.0), 2),
                "retries": rec.retries, "path": rec.path}
            if qmax.get("q_error", 0.0) > worst["q_error"]:
                worst = {"q": qnum, "op": qmax["op"],
                         "q_error": round(qmax["q_error"], 2)}
    s.close()
    return {"queries": len(per_query),
            "all_operators_covered": all(
                v["operators"] == v["with_qerror"]
                for v in per_query.values()),
            "worst_misestimate": worst,
            "cost_model": cost_model_validation(db, lhashes),
            "per_query": per_query}


def cost_model_validation(db, lhashes=None) -> dict:
    """``_cost_model_validation`` (``planqual_bench.py:134-196``) over
    gv$plan_choice's executed plans (those of ``lhashes`` only, when
    given): the chosen plans' margin over their runner-up, and whether
    predicted seconds rank the plans as measured device seconds do.  An
    execution counts once it measured device seconds, which the port's
    CPU never does."""
    rows = [r for r in db.plan_choice.rows() if r["executions"] > 0
            and (lhashes is None or r["logical_hash"] in lhashes)]
    cbo = [r for r in rows if r["enumerated"] > 1 and r["pred_s"] > 0]
    margins = sorted(r["margin"] for r in cbo if r["runner_up_s"] > 0)
    pairs = conc = 0
    ranked = [r for r in cbo if r["device_s_mean"] > 0]
    for i in range(len(ranked)):
        for j in range(i + 1, len(ranked)):
            a, b = ranked[i], ranked[j]
            if (a["pred_s"] == b["pred_s"]
                    or a["device_s_mean"] == b["device_s_mean"]):
                continue
            pairs += 1
            conc += int((a["pred_s"] > b["pred_s"])
                        == (a["device_s_mean"] > b["device_s_mean"]))
    mm = planes.median(margins)
    return {"plans_recorded": len(rows),
            "plans_enumerated": len(cbo),
            "plans_with_runner_up": len(margins),
            "index_probe_plans":
                sum(1 for r in rows if r["index_probes"] > 0),
            "median_margin": round(mm, 3) if mm is not None else None,
            "ranking_pairs": pairs,
            "ranking_agreement":
                round(conc / pairs, 3) if pairs else None}


def overhead(db, repeats: int = REPEATS) -> dict:
    """The overhead half on ``db``, whose ``lineitem`` holds the slice
    -> the reference's record, with the answers beside it."""
    s = db.session()
    with planes.kept(db, OVERHEAD_KNOBS):
        def monitoring(on: bool):
            planes.alter(s, "enable_sql_plan_monitor", on)
            planes.alter(s, "enable_plan_feedback", on)

        monitoring(True)
        on_rows = planes.answers(s)
        monitoring(False)
        off_rows = planes.answers(s)
        planes.time_queries(s, planes.WARM)
        samples = max(repeats // PER_SAMPLE, MIN_SAMPLES)
        off_times, on_times = [], []
        for i in range(samples):
            for mode in ((False, True) if i % 2 == 0 else (True, False)):
                monitoring(mode)
                dt = planes.time_queries(s, PER_SAMPLE)
                (on_times if mode else off_times).append(dt)
        monitoring(True)
    s.close()
    off_m, on_m = planes.median(off_times), planes.median(on_times)
    return {"repeats": samples * PER_SAMPLE,
            "off_s": round(sum(off_times), 4),
            "on_s": round(sum(on_times), 4),
            "mean_overhead_pct": round(
                planes.pct(sum(on_times), sum(off_times)), 2),
            "overhead_pct": round(planes.pct(on_m, off_m), 2),
            "rows_equal": on_rows == off_rows, "answers": on_rows}


def _seed_join(s, n: int = JOIN_ROWS):
    """``fa`` and ``fb`` with every ``k`` 1 (``planqual_bench.py:
    265-271``)."""
    s.execute("create table fa (id int primary key, k int)")
    s.execute("create table fb (id int primary key, k int)")
    s.execute("insert into fa values "
              + ",".join(f"({i},1)" for i in range(n)))
    s.execute("insert into fb values "
              + ",".join(f"({i},1)" for i in range(n)))


def feedback(open_db, root: str, metrics=port_metrics) -> dict:
    """The feedback half: for feedback on and off, a fresh Database at
    ``root/<mode>`` (opened by ``open_db(path)``) -> the reference's
    record, with each answer's check beside it."""

    def retries():
        return int(metrics.sysstat_dict().get("plan.capacity_retries", 0))

    out = {}
    for mode in ("on", "off"):
        db = open_db(os.path.join(root, mode))
        s = db.session()
        planes.alter(s, "enable_plan_feedback", mode == "on")
        _seed_join(s)
        r0 = retries()
        first_ok = [tuple(r) for r in s.execute(JOIN_QUERY).rows()] == \
            JOIN_ANSWER
        first = retries() - r0
        # a fresh session has a cold plan cache: only gv$plan_feedback
        # can save it from riding the ladder again
        s2 = db.session()
        r1 = retries()
        second_ok = [tuple(r) for r in s2.execute(JOIN_QUERY).rows()] == \
            JOIN_ANSWER
        second = retries() - r1
        out[mode] = {"first_run_retries": first,
                     "fresh_session_retries": second,
                     "answers_ok": first_ok and second_ok}
        s2.close()
        s.close()
        db.close()
    return out


def skew_tables(n_rows: int = SKEW_ROWS) -> dict:
    """{table: (matching ids, other ids)} of the skew half
    (``planqual_bench.py:319-348``): ``skewed``'s matching rows all hash
    into slice 0 of ``SKEW_PARTS``, ``uniform``'s keys are random."""
    from oceanbase_tpu_torch.px.dtl import slice_mask

    ids = np.arange(n_rows * 4, dtype=np.int64)
    in_part0 = slice_mask({"k": ids}, ["k"], 0, SKEW_PARTS)
    n_match = n_rows // 3
    uni = np.random.default_rng(SKEW_SEED).permutation(ids)[:n_rows]
    return {"skewed": (ids[in_part0][:n_match],
                       ids[~in_part0][:n_rows - n_match]),
            "uniform": (uni[:n_match], uni[n_match:])}


def skew(c, n_rows: int = SKEW_ROWS, node: int = 1) -> dict:
    """The skew half on ``c`` (a ``ClusterClient`` with
    ``dtl_min_rows = 1``), every statement on ``node`` -> the reference's
    record, each table's answer size and pushdown beside its skew."""
    lead_from(c, node)

    def sql(text):
        return c.execute(node, text, deadline_s=QUERY_S)

    tables = skew_tables(n_rows)
    n_match = len(tables["skewed"][0])
    for table, (match, rest) in tables.items():
        sql(f"create table {table} (k int primary key, flag int, v int)")
        rows = [(int(k), 1, int(k) % 97) for k in match] + \
               [(int(k), 0, int(k) % 97) for k in rest]
        for st in range(0, len(rows), SKEW_BATCH):
            sql(f"insert into {table} values " + ", ".join(
                f"({k}, {f}, {v})" for k, f, v in rows[st:st + SKEW_BATCH]))
    for table in tables:
        c.wait_count(table, n_rows, [i for i in c.clients if i != node])
    out = {"rows": n_rows, "matching": n_match}
    for table in tables:
        got = rows_of(sql(f"select v from {table} where flag = 1"))
        (skew_, mx, mean, parts, hit), = rows_of(sql(
            "select slice_skew, max_slice_rows, mean_slice_rows, parts,"
            " pushdown_hit from gv$px_exchange where mode = 'pushdown'"
            " order by ts desc limit 1"))
        out[table] = {"slice_skew": round(float(skew_), 3),
                      "max_slice_rows": int(mx),
                      "mean_slice_rows": round(float(mean), 1),
                      "parts": int(parts), "answer_rows": len(got),
                      "pushdown_hit": int(hit)}
    return out


def skew_visible(sk: dict) -> bool:
    """The reference's ``skew_visible`` check (:411-414)."""
    return (sk["skewed"]["slice_skew"] >= SKEWED_MIN
            and sk["uniform"]["slice_skew"] < UNIFORM_MAX)


def skew_failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the skew record ``rec`` breaks, by name: the reference's
    asserts (each filter pushed down and answering its matching rows)
    and ``skew_visible`` (it reads no time: ``timing`` changes
    nothing)."""
    bad = []
    for table in ("skewed", "uniform"):
        t = rec.get(table, {})
        if t.get("answer_rows") != rec.get("matching") or \
                t.get("pushdown_hit") != 1:
            bad.append(f"{table}: {t.get('answer_rows')} rows of "
                       f"{rec.get('matching')}, pushdown_hit "
                       f"{t.get('pushdown_hit')}")
    if not bad and not skew_visible(rec):
        bad.append(f"skew_visible: skewed {rec['skewed']['slice_skew']} "
                   f"(>= {SKEWED_MIN}), uniform "
                   f"{rec['uniform']['slice_skew']} (< {UNIFORM_MAX})")
    return bad


def coverage_checks(cov: dict) -> dict:
    """The gate's checks of the coverage half."""
    cm = cov["cost_model"]
    return {
        "qerror_all_operators": bool(cov["all_operators_covered"]),
        "cost_model_choices_recorded":
            cm["plans_enumerated"] >= MIN_ENUMERATED
            and cm["plans_with_runner_up"] >= MIN_RUNNER_UP,
        "cost_model_ranking":
            cm["ranking_agreement"] is None
            or cm["ranking_agreement"] >= MIN_RANKING,
    }


def checks(cov: dict, ovh: dict, fb: dict, sk: dict | None = None) -> dict:
    """The reference's gate (``planqual_bench.py:393-416``), the
    cluster's ``skew_visible`` where the skew half ran."""
    out = {
        **coverage_checks(cov),
        "overhead_le_2pct": ovh["overhead_pct"] <= planes.BOUND_PCT,
        "feedback_one_retry":
            fb["on"]["first_run_retries"] == 1
            and fb["on"]["fresh_session_retries"] == 0,
        "ladder_without_feedback": fb["off"]["first_run_retries"] >= 2,
    }
    if sk is not None:
        out["skew_visible"] = skew_visible(sk)
    return out


#: the checks that read measured time: the overhead against its bound,
#: and predicted seconds ranked against measured device seconds
TIMING = ("overhead_le_2pct", "cost_model_ranking")


def run(tpch_db, slice_db, open_db, feedback_root: str, sf: float = SF,
        repeats: int = REPEATS, metrics=port_metrics,
        cluster_half=None) -> dict:
    """The reference's line: coverage on ``tpch_db`` (its tables loaded,
    ANALYZEd and indexed at ``sf``), the overhead half on ``slice_db``
    (fresh; the slice is direct-loaded into it), the feedback half under
    ``feedback_root``, then ``cluster_half()`` (``skew`` on a cluster of
    its own) unless it is None, as ``PLANQUAL_SKIP_CLUSTER`` skips it."""
    result = {"metric": "planqual_bench", "sf": sf}
    cov = coverage(tpch_db)
    result["coverage"] = {"sf": sf, **cov}
    s = slice_db.session()
    planes.load_numpy(s, ROWS)
    s.close()
    result["overhead"] = {"rows": ROWS, **overhead(slice_db, repeats)}
    result["feedback"] = feedback(open_db, feedback_root, metrics)
    result["skew"] = ({"skipped": True} if cluster_half is None
                      else cluster_half())
    result["checks"] = checks(cov, result["overhead"], result["feedback"],
                              None if cluster_half is None
                              else result["skew"])
    result["ok"] = all(result["checks"].values())
    result["sysstat"] = metrics.sysstat_dict()
    return result


def failures(rec: dict, timing: bool = True) -> list[str]:
    """Each gate the line ``rec`` breaks, by name: the answers of the
    overhead and feedback halves, the skew half's asserts where it ran,
    then the reference's checks (those in ``TIMING`` only with
    ``timing``)."""
    bad = []
    if not rec.get("overhead", {}).get("rows_equal"):
        bad.append("rows_equal: monitoring changed results")
    for mode in ("on", "off"):
        if not rec.get("feedback", {}).get(mode, {}).get("answers_ok"):
            bad.append(f"feedback {mode} answers_ok")
    sk = rec.get("skew", {})
    if sk and not sk.get("skipped"):
        bad += [b for b in skew_failures(sk)
                if not b.startswith("skew_visible")]
    for name, ok in rec.get("checks", {}).items():
        if not ok and (timing or name not in TIMING):
            bad.append(name)
    return bad
