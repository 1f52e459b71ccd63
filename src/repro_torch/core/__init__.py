"""Cox partial likelihood, surrogate minimizers and coordinate descent."""
