"""Evaluation of the port: full-split scoring, best keeping, the loop evaluator."""
