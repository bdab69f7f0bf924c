"""The job master (``job_master``): its servicer and transport, the
rendezvous, node, task and speed ledgers, the timeline, the auto-scaler,
the KV store, the sync service, the metrics store, the state store, and
the measurement planes' two ledgers (``calibration``, ``memory_ledger``).
The rest of the reference's master (diagnosis, brain, HTTP plane, cloud
launcher) is ROADMAP Queue 1 item 10b's remainder."""
