"""Multi-GPU training of the port: process groups from the JobSet env
(``distributed``), the mesh (``mesh``), the sharding plan
(``sharding``), collectives (``collectives``) and topology descriptors
(``topology``)."""
