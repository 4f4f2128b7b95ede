"""Lossy gradient compression (port, part): only the configuration the
scenario presets carry. Selection, error feedback and the sparse wire
format are ROADMAP Queue 1, item 6."""
