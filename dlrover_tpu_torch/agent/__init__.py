"""The node agent: the elastic agent that supervises the trainer
(``training_agent``), its master client (``master_client``), the trainer's
stack dump (``stack_collector``) and resource sampling (``monitor``)."""
