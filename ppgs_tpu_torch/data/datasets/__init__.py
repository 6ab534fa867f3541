from . import arctic, commonvoice, timit, words
