"""Control-plane messages (the data-sharding pair and the serving front
door's), the serving replica policy, and the measurement planes' two
ledgers (``calibration``, ``memory_ledger``); the master itself is
ROADMAP Queue 1 item 10b."""
