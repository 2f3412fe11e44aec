"""Commitments: KZG values, PST multilinear KZG, and the device MSM."""
