from .core import datasets, arctic, commonvoice, timit
