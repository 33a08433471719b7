"""Test/bench support utilities (fault injection, …) — importable from
production code but inert unless explicitly armed."""
