"""The node agent's side of the measurement planes: ``monitor`` (host
and device resource sampling, the trainer's device-metrics file).  The
agent's master client and training agent are ROADMAP Queue 1 item 10b."""
