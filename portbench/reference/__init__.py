"""Plain references that decide whether a run's answers are correct."""
