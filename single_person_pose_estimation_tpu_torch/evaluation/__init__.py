"""Evaluation: prediction over records, OKS and PCK."""
