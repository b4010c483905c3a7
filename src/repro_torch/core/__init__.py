"""SGNS window math, the training session and quality metrics (torch)."""
