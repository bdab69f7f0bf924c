"""Control-plane messages (the data-sharding pair and the serving front
door's) and the serving replica policy; the master itself is ROADMAP
Queue 1 item 10."""
