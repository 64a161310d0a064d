"""GGIPNN train/eval CLI, on the GPU.

    python -m gene2vec_tpu_torch.cli.ggipnn --data-dir predictionData/ \\
        --emb gene2vec_dim_200_iter_9_w2v.txt [--run-dir runs/1] [--device cuda|cpu]

The reference CLI's flags (``gene2vec_tpu/cli/ggipnn.py``): embedding
dim, embedTrain, use_pre_trained, batch size, epochs, eval/checkpoint
cadence; the data layout is a ``predictionData/``-shaped directory with
train/valid/test ``_text.txt`` + ``_label.txt`` files.  Prints the test
accuracy and AUC.  ``--device`` defaults to ``cuda`` and the run refuses
to start without a GPU unless ``--device cpu`` is given.

SIGTERM/SIGINT drain the run (under ``--run-dir``, a checkpoint at the
step in flight) and the CLI exits 113 with no test-set pass.  There is no
resume path: a rerun retrains from scratch.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from gene2vec_tpu_torch.config import GGIPNNConfig


def build_parser() -> argparse.ArgumentParser:
    d = GGIPNNConfig()
    p = argparse.ArgumentParser(
        prog="ggipnn",
        description="Train the gene-gene-interaction MLP and print test AUC.",
        epilog="On preemption (SIGTERM/SIGINT) training drains and the CLI exits "
               "113; a rerun restarts training.",
    )
    p.add_argument("--data-dir", required=True, help="predictionData/-shaped directory")
    p.add_argument("--emb", default=None,
                   help="pretrained embedding file (matrix-txt or w2v format)")
    p.add_argument("--embedding-dim", type=int, default=d.embedding_dim)
    p.add_argument("--embed-train", action="store_true",
                   help="fine-tune the embedding table (default frozen)")
    p.add_argument("--no-pretrained", action="store_true",
                   help="skip pretrained embedding (random table)")
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--num-epochs", type=int, default=d.num_epochs)
    p.add_argument("--learning-rate", type=float, default=d.learning_rate)
    p.add_argument("--dropout-keep-prob", type=float, default=d.dropout_keep_prob)
    p.add_argument("--l2-lambda", type=float, default=d.l2_lambda)
    p.add_argument("--evaluate-every", type=int, default=d.evaluate_every)
    p.add_argument("--checkpoint-every", type=int, default=d.checkpoint_every)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--run-dir", default=None,
                   help="write a runs/<ts>-style artifact dir (train/dev summaries "
                        "with gradient sparsity, keep-5 step checkpoints) at the "
                        "reference cadence; runs the per-batch step loop")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    config = GGIPNNConfig(
        embedding_dim=args.embedding_dim,
        embed_train=args.embed_train,
        use_pretrained=not args.no_pretrained and args.emb is not None,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        dropout_keep_prob=args.dropout_keep_prob,
        l2_lambda=args.l2_lambda,
        evaluate_every=args.evaluate_every,
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
    )
    from gene2vec_tpu_torch.models.ggipnn_train import run_classification
    from gene2vec_tpu_torch.resilience.preempt import EXIT_PREEMPTED, PreemptionHandler

    with PreemptionHandler() as handler:
        run_classification(args.data_dir, args.emb, config, run_dir=args.run_dir,
                           device=args.device, preempt=handler)
    if handler.triggered:
        # 113 here means "drained cleanly", not "resume me": a rerun
        # retrains from scratch (--run-dir step checkpoints are artifacts
        # for analysis, not resume points)
        print(
            f"preempted (signal {handler.received}); training drained "
            "cleanly. NOTE: ggipnn has no resume path — rerunning "
            "restarts training"
            + (" (step checkpoints are under --run-dir)" if args.run_dir else ""),
            file=sys.stderr,
        )
        return EXIT_PREEMPTED
    return 0


if __name__ == "__main__":
    sys.exit(main())
