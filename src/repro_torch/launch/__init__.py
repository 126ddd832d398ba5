"""Step functions and entry points (the serving half of the reference's
``repro.launch``; its training half waits for ROADMAP queue A items 6 and 8)."""
