"""RL plane: only ``SamplingParams`` so far (used by serving)."""
