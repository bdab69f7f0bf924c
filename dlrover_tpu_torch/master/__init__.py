"""Control-plane messages (the data-sharding pair only; the master itself
is ROADMAP Queue 1 item 10)."""
