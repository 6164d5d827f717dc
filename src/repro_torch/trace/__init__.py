"""Run provenance and the profile files of a run (the start of the
counterpart of ``repro/trace/``; sessions, export and streaming come with
ROADMAP M11)."""
