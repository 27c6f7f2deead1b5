"""The annealed accept/reject solver."""
