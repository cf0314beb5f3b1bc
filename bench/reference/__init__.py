"""The benchmark's plain float32 reference: its own PSI rounding, its
weight draw and the decoder forward. Imports torch alone."""
