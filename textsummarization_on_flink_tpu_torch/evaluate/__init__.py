"""ROUGE scoring of decoded summaries (evaluate/rouge.py)."""
