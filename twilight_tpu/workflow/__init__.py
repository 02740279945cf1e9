"""Workflow layer: iterative tree-estimation + alignment pipelines.

Self-contained replacement for the reference's Snakemake workflow
(/root/reference/workflow/Snakefile:1-188, rules/twilight.smk): instead of
shelling out to external tree tools (maffttree/parttree/fasttree/rapidnj/
iqtree/raxml/mashtree), tree estimation is built in (twilight_tpu.trees —
k-mer sketch distances for iteration 0, MSA p-distances after; NJ/PartTree
construction). The reference's placement mode additionally needs epa-ng +
gappa, which are external binaries; when absent, this module's placement
entry falls back to TWILIGHT's own PLACE_W_TREE alignment path.
"""
from .iterative import run_iterative

__all__ = ["run_iterative"]
