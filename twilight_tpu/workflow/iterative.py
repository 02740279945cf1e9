"""Iterative mode: estimate tree -> align -> re-estimate -> realign.

Mirrors the reference workflow's iteration chain
(/root/reference/workflow/Snakefile:144-172; rules/twilight.smk runs
twilight per iteration, scripts/reduceLen.py masks gappy columns before
tree inference — our msa_distances does that masking internally).
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

from ..seqio.fasta import iter_fasta
from ..trees import build_guide_tree


def run_iterative(seq_file: str, out_file: str, iterations: int = 2,
                  temp_dir: Optional[str] = None, type_: Optional[str] = None,
                  backend: str = "auto", extra_args: Optional[List[str]] = None,
                  keep_temp: bool = False, tree_tool: str = "auto",
                  init_tool: Optional[str] = None,
                  iter_tool: Optional[str] = None,
                  final_tool: Optional[str] = None) -> None:
    """init_tool/iter_tool/final_tool mirror the reference Snakefile's
    INITTREE/ITERTREE/FINALTREE knobs (workflow/config.yaml:7-9); when
    unset they derive from the single `tree_tool` preference. A final
    tree, when requested, is written to `<out_file>.tree` like the
    Snakefile's finaltree target (Snakefile checkFiles)."""
    from .. import cli

    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    temp_dir = temp_dir or (os.path.splitext(out_file)[0] + "_iter")
    os.makedirs(temp_dir, exist_ok=True)

    names: List[str] = []
    seqs: List[str] = []
    for n, _, s in iter_fasta(seq_file):
        names.append(n)
        seqs.append(s)

    prev_aln: Optional[str] = None
    for it in range(iterations):
        tree_path = os.path.join(temp_dir, f"iter{it}.nwk")
        aln_path = (out_file if it == iterations - 1
                    else os.path.join(temp_dir, f"iter{it}.aln"))
        if it == 0:
            # initial tree from unaligned sequences: MAFFT(-PartTree) /
            # mashtree / dipper when on PATH (reference rules/
            # {maffttree,parttree,mashtree,dipper_init}.smk), else the
            # built-in k-mer estimator. An MSA-only tool choice (e.g.
            # fasttree) applies from iteration 1 on.
            from ..trees.external import UNALIGNED_TOOLS, guide_tree_auto
            tool0 = init_tool or (
                tree_tool if (tree_tool in UNALIGNED_TOOLS
                              or tree_tool == "auto") else "builtin")
            newick = guide_tree_auto(names, seqs, aligned=False,
                                     type_=type_ or "n", tool=tool0)
        else:
            rows_by_name = {}
            for n, _, s in iter_fasta(prev_aln):
                rows_by_name[n] = s
            rows = [rows_by_name[n] for n in names]
            from ..trees.external import guide_tree_auto
            newick = guide_tree_auto(names, rows, aligned=True,
                                     type_=type_ or "n",
                                     tool=iter_tool or tree_tool)
        with open(tree_path, "w") as f:
            f.write(newick + "\n")
        print(f"[twilight-tpu] iteration {it}: tree -> {tree_path}",
              file=sys.stderr)
        args = ["-t", tree_path, "-i", seq_file, "-o", aln_path,
                "--overwrite", "--backend", backend]
        if type_:
            args += ["--type", type_]
        args += list(extra_args or [])
        rc = cli.main(args)
        if rc != 0:
            raise RuntimeError(f"alignment failed at iteration {it}")
        prev_aln = aln_path
    if final_tool:
        # Snakefile finaltree target: a higher-quality tree inferred
        # from the final MSA, written next to it as <out>.tree
        from ..trees.external import guide_tree_auto
        rows_by_name = {}
        for n, _, s in iter_fasta(prev_aln):
            rows_by_name[n] = s
        rows = [rows_by_name[n] for n in names]
        newick = guide_tree_auto(names, rows, aligned=True,
                                 type_=type_ or "n", tool=final_tool)
        with open(out_file + ".tree", "w") as f:
            f.write(newick + "\n")
        print(f"[twilight-tpu] final tree -> {out_file}.tree",
              file=sys.stderr)
    if not keep_temp:
        for f in os.listdir(temp_dir):
            if f.startswith("iter"):
                os.unlink(os.path.join(temp_dir, f))
        try:
            os.rmdir(temp_dir)
        except OSError:
            pass


def main(argv=None) -> int:
    """Workflow driver. Mode selection mirrors the reference Snakefile
    (/root/reference/workflow/Snakefile:102-104): a backbone alignment
    (-a) selects placement mode, otherwise iterative mode. Default
    iteration counts match the Snakefile (3 iterative / 2 placement)."""
    import argparse
    p = argparse.ArgumentParser(
        prog="twilight-tpu-workflow",
        description="Iterative / placement alignment workflows "
                    "(TWILIGHT workflow equivalent, no external tools)")
    p.add_argument("-i", "--sequences", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-a", "--alignment",
                   help="backbone MSA: selects placement mode")
    p.add_argument("-t", "--tree",
                   help="backbone tree for placement mode (estimated "
                        "from the backbone MSA when omitted)")
    p.add_argument("-n", "--iterations", type=int, default=0,
                   help="default: 3 iterative / 2 placement")
    p.add_argument("-d", "--temp-dir")
    p.add_argument("--type", choices=["n", "p"])
    p.add_argument("--backend",
                   choices=["auto", "gpu", "cpu", "native", "numpy"],
                   default="auto")
    p.add_argument("-k", "--keep-temp", action="store_true")
    p.add_argument("--tree-tool", default="auto",
                   help="tree inference between iterations: auto "
                        "(external tool if on PATH), builtin, fasttree, "
                        "rapidnj, iqtree")
    p.add_argument("--init-tree", default=None,
                   help="initial guide-tree method (Snakefile INITTREE: "
                        "dipper, parttree, maffttree)")
    p.add_argument("--iter-tree", default=None,
                   help="between-iteration method (Snakefile ITERTREE: "
                        "dipper, rapidnj, fasttree)")
    p.add_argument("--final-tree", default=None,
                   help="final-MSA tree method, written to <out>.tree "
                        "(Snakefile FINALTREE: fasttree, raxml, iqtree)")
    if argv is None:
        argv = sys.argv[1:]
    if "--config" in argv:
        from .snakeconfig import config_to_argv
        argv = config_to_argv(argv)
    args, extra = p.parse_known_args(argv)
    # iterations run cli.main in-process: share one device kernel across
    # them (warm-up + compiled programs survive; see
    # ops/device_kernel.make_device_kernel)
    os.environ.setdefault("TWILIGHT_KERNEL_PERSIST", "1")
    rc = 0
    try:
        if args.alignment:
            from .placement import run_placement
            run_placement(args.sequences, args.alignment, args.output,
                          args.tree, args.iterations or 2, args.temp_dir,
                          args.type, args.backend, extra, args.keep_temp,
                          final_tool=args.final_tree)
        else:
            run_iterative(args.sequences, args.output,
                          args.iterations or 3, args.temp_dir, args.type,
                          args.backend, extra, args.keep_temp,
                          tree_tool=args.tree_tool,
                          init_tool=args.init_tree,
                          iter_tool=args.iter_tree,
                          final_tool=args.final_tree)
    except (RuntimeError, ValueError) as e:
        # e.g. an explicitly requested tree tool missing from PATH — a
        # user error the reference's snakemake rule would also fail on
        print(f"ERROR: {e}", file=sys.stderr)
        rc = 1
    from ..ops import device_kernel
    device_kernel.close_persistent()
    return rc


if __name__ == "__main__":   # python -m twilight_tpu.workflow.iterative
    sys.exit(main())
