"""Embodied QA driver (reference agent_eqa.py:267-340 +
EQA_benchmark.py): per-question anchor navigation + view collection +
VLM answer, with incremental results-json resume.

  python -m bsc_nav_tpu_torch.drivers.eqa --env fake --episodes 3 --llm mock

The port's counterpart of ``benchmarks/eqa.py`` over the port's robot;
``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

from bsc_nav_tpu_torch.drivers import common as C
from bsc_nav_tpu_torch.drivers import setup as S
from bsc_nav_tpu_torch.agents.eqa import EQAAgent


def main(argv=None):
    p = argparse.ArgumentParser()
    S.add_common_args(p)
    p.add_argument("--results-json", type=str, default=None,
                   help="answers json (default: next to the CSV, not "
                        "the cwd)")
    args = p.parse_args(argv)
    csv_path = args.csv or "eqa_results.csv"
    if args.results_json is None:
        args.results_json = os.path.join(
            os.path.dirname(os.path.abspath(csv_path)),
            "eqa_results.json")

    cfg, bench, memory, extras = S.build_world(args, task="eqa")
    robot = EQAAgent(memory, bench, llm_client=extras["llm"],
                     matcher=extras["matcher"], llm_model=args.llm_model)

    # incremental resume by question id (agent_eqa.py:287-296)
    results = []
    if os.path.exists(args.results_json):
        with open(args.results_json) as f:
            results = json.load(f)
    finished = {r.get("question_id") for r in results}

    # question-metadata dump, written BEFORE answering (reference
    # EQA_benchmark.py:66-81 collects question_text/answer_text/
    # question_type for every episode into eqa_questions_meta.json)
    meta_path = os.path.join(
        os.path.dirname(os.path.abspath(args.results_json)),
        "eqa_questions_meta.json")
    questions_meta = []
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            questions_meta = json.load(f)
    meta_seen = {m.get("question_id") for m in questions_meta}

    for i in range(args.episodes):
        obs = bench.reset()
        ep = bench.current_episode
        qid = f"{ep.scene_id}_{i}"
        if qid in finished:
            continue
        if args.env == "fake":
            S.ensure_memory_fake(robot, bench)
        robot.reset(obs, log_dir=os.path.join(args.log_root,
                                              f"trajectory_{i}"))
        question = ep.question or f"What is next to the {ep.object_category}?"

        truth_pre = (S.FAKE_COLOR_NAMES.get(ep.object_category)
                     if args.env == "fake" else None)
        if qid not in meta_seen:
            questions_meta.append({
                "question_id": qid,
                "question_text": question,
                "answer_text": truth_pre,
                "question_type": "color" if truth_pre else None,
            })
            meta_seen.add(qid)
            with open(meta_path, "w", encoding="utf-8") as f:
                json.dump(questions_meta, f, ensure_ascii=False, indent=2)

        _, answer = robot.main(question)

        m = bench.get_metrics()
        island, area = S.island_stats(bench)
        # EQA success = answer accuracy (reference EQA_benchmark.py keys
        # results on the answer, not nav success); ground truth known in
        # the fake world
        truth = truth_pre
        correct = (float(truth.lower() in (answer or "").lower())
                   if truth else None)
        # record the question in the resume json BEFORE the CSV append:
        # a crash between the two writes must not re-run the question
        # and duplicate its CSV row on resume
        results.append({"question_id": qid, "question": question,
                        "answer_4o": answer,
                        **({"ground_truth": truth} if truth else {})})
        with open(args.results_json, "w") as f:
            json.dump(results, f, indent=2)

        C.write_metrics({
            "success": m["success"], "spl": m["spl"],
            "Ospl": m["oracle_spl"],
            "distance_to_goal": m["distance_to_goal"],
            **({"answer_correct": correct} if correct is not None else {}),
            "id": ep.scene_id, "island": island, "island_area": area,
            **C.nav_telemetry(robot),
        }, csv_path)
    return results


if __name__ == "__main__":
    main()
