"""The job master (``job_master``): its servicer and transport, the
rendezvous, node, task and speed ledgers, the timeline, the auto-scaler
and its running-job optimizer (``brain``), the diagnosis chain, the HTTP
scrape plane, the cloud launcher (``cloud_launcher``, ``tpu_api``), the KV
store, the sync service, the metrics store, the state store, and the
measurement planes' two ledgers (``calibration``, ``memory_ledger``)."""
